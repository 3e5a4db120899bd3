from .voxel_map import VoxelMap, VoxelMapConfig  # noqa: F401
