from .model import Model, build_model  # noqa: F401
