from .ate import evaluate_ate, TrajectoryError  # noqa: F401
