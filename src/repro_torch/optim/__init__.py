"""Optimizers over pytrees of tensors (port of ``repro.optim``)."""
from .optimizers import Optimizer, OptimizerConfig, make

__all__ = ["Optimizer", "OptimizerConfig", "make"]
