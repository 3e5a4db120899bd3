from .node_store import NodeStore  # noqa: F401
from .manager import GraphManager  # noqa: F401
