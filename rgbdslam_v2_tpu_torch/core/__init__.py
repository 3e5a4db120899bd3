"""SE(3) geometry, pinhole camera, depth noise, rigid alignment."""
