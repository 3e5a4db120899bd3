"""Host utilities: scoped timers and the named loggers (ports of the JAX
package's ``utils``), and ``roofline``, the step's stages timed on the card
against the H100's peaks."""
from .timing import ScopedTimer, timing_stats, reset_timing_stats  # noqa: F401
from .logsetup import get_logger, configure_logging  # noqa: F401
