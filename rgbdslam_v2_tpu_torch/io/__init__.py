from .tum import TumDataset, TumLoader, associate, write_trajectory  # noqa: F401
from .synthetic import SyntheticWorld, render_sequence, save_as_tum_dataset  # noqa: F401
