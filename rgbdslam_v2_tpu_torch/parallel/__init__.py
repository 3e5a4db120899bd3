from .mesh import DeviceMesh, candidate_mesh  # noqa: F401
from .multi_eval import VoResult, vo_trajectories_sharded  # noqa: F401
from .sharded import sharded_compare, sharded_lm_iteration  # noqa: F401
