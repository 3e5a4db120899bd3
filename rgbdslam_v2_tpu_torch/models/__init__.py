from .types import Keypoints  # noqa: F401
from .orb import OrbExtractor  # noqa: F401
