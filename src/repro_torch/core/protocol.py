"""Protocol configuration (port of ``repro/core/protocol.py:48-101``).

Only the configuration the engine reads lives here; the pytree
protocol operators of the reference serve the LM layers and are not
ported yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

# Stable integer codes for the protocol kinds.
PROTOCOL_KIND_CODES = {"none": 0, "continuous": 1, "periodic": 2, "dynamic": 3}


@dataclasses.dataclass(frozen=True)
class ProtocolConfig:
    """Configuration of a distributed online learning protocol.

    kind: ``none | continuous | periodic | dynamic``; ``period`` is the
    periodic protocol's b, ``delta`` the dynamic protocol's threshold
    Delta, ``mini_batch`` how often (in rounds) the dynamic protocol
    checks its local conditions.  The reference's other fields
    (``per_group``, ``delta_schedule``, ...) serve its pytree protocol
    operators and come with them (ROADMAP.md); ``engine.run`` reads
    none of them.
    """

    kind: str = "dynamic"
    period: int = 1
    delta: float = 0.1
    mini_batch: int = 1

    def __post_init__(self) -> None:
        if self.kind not in PROTOCOL_KIND_CODES:
            raise ValueError(f"unknown protocol kind: {self.kind!r}")
        if self.period < 1:
            raise ValueError("period must be >= 1")
        if self.delta < 0:
            raise ValueError("delta must be >= 0")

    @property
    def kind_code(self) -> int:
        """Integer code of ``kind`` (see PROTOCOL_KIND_CODES)."""
        return PROTOCOL_KIND_CODES[self.kind]
