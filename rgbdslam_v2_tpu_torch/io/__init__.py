from .tum import associate, write_trajectory  # noqa: F401
from .synthetic import SyntheticWorld, render_sequence  # noqa: F401
