"""The paper's own 'architecture': distributed kernel online learners
(repro/configs/paper_kernel.py).

Not a transformer: this config names the RKHS learner setup of the
paper's experiments (SUSY-like classification, Fig. 1; stock
regression, Fig. 2), so it is selectable by ``--arch paper_kernel``.
Its learner and protocol are the port's own ``LearnerConfig`` and
``ProtocolConfig``, which ``core.engine.run`` takes.
"""
import dataclasses

from .base import _REGISTRY
from ..core.learners import LearnerConfig
from ..core.protocol import ProtocolConfig
from ..core.rkhs import KernelSpec


@dataclasses.dataclass(frozen=True)
class PaperKernelConfig:
    name: str = "paper_kernel"
    arch_type: str = "kernel"
    learner: LearnerConfig = dataclasses.field(default_factory=lambda: LearnerConfig(
        algo="kernel_sgd", loss="hinge", eta=0.5, lam=0.01, budget=64,
        kernel=KernelSpec(kind="gaussian", gamma=0.5), dim=8,
    ))
    protocol: ProtocolConfig = dataclasses.field(default_factory=lambda: ProtocolConfig(
        kind="dynamic", delta=1.0,
    ))
    m: int = 4

    def smoke(self):
        return dataclasses.replace(self, learner=dataclasses.replace(
            self.learner, budget=16), m=2)


CONFIG = PaperKernelConfig()
_REGISTRY["paper_kernel"] = CONFIG
