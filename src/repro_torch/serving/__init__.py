"""Online serving layer (port of ``repro.serving``).

:class:`KernelServingEngine` serves predict requests from m learners
of any substrate while they learn online and synchronize, on one
seeded event timeline; ``serve_stream`` replays a (T, m, d) stream
through it with query traffic from the seeded arrival processes.  The
protocol view equals ``core.engine.run``'s on the same device, and the
serving face equals the reference's (tests/test_torch_serving.py).

``serving.lm`` holds the separate LM token-serving engine
(``LMServingEngine``); as in the reference it is not imported here, so
the kernel-serving path never loads the LM stack: import
``repro_torch.serving.lm`` to use it.
"""
from .arrivals import (ARRIVAL_KINDS, ArrivalProcess, BurstyArrivals,
                       DiurnalArrivals, PoissonArrivals, make_arrivals)
from .engine import (DEFAULT_BUCKETS, KernelServingEngine, PredictRequest,
                     ServeResult, serve_stream)
from .scheduler import (POLICIES, ContinuousScheduler, SlotPool,
                        SlotScheduler, TickScheduler, make_scheduler)

__all__ = [
    "ARRIVAL_KINDS", "ArrivalProcess", "BurstyArrivals", "DiurnalArrivals",
    "PoissonArrivals", "make_arrivals",
    "DEFAULT_BUCKETS", "KernelServingEngine", "PredictRequest",
    "ServeResult", "serve_stream",
    "POLICIES", "ContinuousScheduler", "SlotPool", "SlotScheduler",
    "TickScheduler", "make_scheduler",
]
