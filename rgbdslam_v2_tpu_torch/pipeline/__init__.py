from .slam import SlamPipeline, EvaluationReport  # noqa: F401
