from .params import ParameterServer, PARAM_DEFS, default_params  # noqa: F401
