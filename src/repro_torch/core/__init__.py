"""Protocols, learners, substrates and the engine (port of ``repro.core``).

``protocol`` (the sync operators over stacked-learner pytrees) is
imported here with its two types, as the reference's package does; the
other modules are imported by name (``repro_torch.core.engine``, ...).
"""
from . import protocol
from .protocol import ProtocolConfig, ProtocolState

__all__ = ["protocol", "ProtocolConfig", "ProtocolState"]
