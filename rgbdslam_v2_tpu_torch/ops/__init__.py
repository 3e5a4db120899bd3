"""Image ops, the detect kernel and its plain version, ORB, matching, RANSAC, EMM."""
