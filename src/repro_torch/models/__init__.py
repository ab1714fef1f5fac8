"""The LM stack of the port: configuration, layers, attention, the
dense decoder and its API (``build``)."""
from .config import ModelConfig, param_count, round_up
from .model import ModelAPI, build, count_params

__all__ = ["ModelConfig", "param_count", "round_up", "ModelAPI", "build",
           "count_params"]
