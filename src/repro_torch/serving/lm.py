"""LM token serving: request queue + prefill + decode loop (port of
``repro/serving/lm.py``).

A fixed-batch engine for the port's LM stack: requests are grouped
into batches of ``batch_size`` (a short batch is filled with dummy
requests), left-padded with token 0 to the longest prompt of the batch
(no attention mask over the pad, as in the reference), prefilled, then
decoded greedily (``argmax`` over the true vocabulary) one step at a
time until every live sequence has hit its eos token or its own
``max_new_tokens``.  ``latency_s`` is the host's ``perf_counter`` from
the batch's start to the request's completion.

Each step reads the batch's next tokens back to the host once (one
``tolist``); the reference reads them element by element.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from .. import device as device_mod
from ..models import build
from ..models.config import ModelConfig


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (S,) token ids
    max_new_tokens: int = 16
    eos_token: Optional[int] = None
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    latency_s: float = 0.0   # batch start -> THIS request's completion


class LMServingEngine:
    """Fixed-batch LM decode engine; sequences in a batch share a
    prefill length (left-padded to the max prompt in the batch).

    ``params`` must live on ``device`` (``None``: the CUDA card, which
    raises where there is none)."""

    def __init__(self, cfg: ModelConfig, params, batch_size: int = 4,
                 max_len: int = 256, device=None):
        self.device = device_mod.resolve(device)
        where = params["embed"]["table"].device
        if where.type != self.device.type:
            raise ValueError(f"the parameters are on {where}, the engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.api = build(cfg)
        self.params = params
        self.B = batch_size
        self.max_len = max_len

    def _make_batch(self, reqs: List[Request]):
        S = max(len(r.prompt) for r in reqs)
        toks = np.zeros((self.B, S), np.int64)
        for i, r in enumerate(reqs):
            toks[i, S - len(r.prompt):] = r.prompt   # left pad with 0
        return {"tokens": torch.as_tensor(toks, device=self.device)}, S

    def _argmax(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits[..., : self.cfg.vocab], dim=-1)   # (B, 1)

    @torch.no_grad()
    def run(self, requests: List[Request]) -> List[Request]:
        queue = list(requests)
        finished: List[Request] = []

        while queue:
            batch_reqs = queue[: self.B]
            queue = queue[self.B:]
            while len(batch_reqs) < self.B:   # pad batch with a dummy
                batch_reqs.append(Request(uid=-1, prompt=np.zeros(1, np.int32),
                                          max_new_tokens=0))
            t0 = time.perf_counter()
            batch, S = self._make_batch(batch_reqs)
            caches = self.api.init_caches(self.B, self.max_len,
                                          device=self.device)
            logits, caches = self.api.prefill(self.params, batch, caches)
            next_tok = self._argmax(logits)

            max_new = max(r.max_new_tokens for r in batch_reqs)
            for step in range(max_new):
                toks = next_tok[:, 0].tolist()
                for i, r in enumerate(batch_reqs):
                    if r.uid >= 0 and not r.done and step < r.max_new_tokens:
                        t = toks[i]
                        r.output.append(t)
                        if ((r.eos_token is not None and t == r.eos_token)
                                or len(r.output) >= r.max_new_tokens):
                            r.done = True
                            r.latency_s = time.perf_counter() - t0
                # early exit: once every live sequence has finished
                if all(r.done or r.uid < 0 for r in batch_reqs):
                    break
                logits, caches = self.api.decode(self.params, caches,
                                                 next_tok, S + step)
                next_tok = self._argmax(logits)

            dt = time.perf_counter() - t0
            for r in batch_reqs:
                if r.uid >= 0:
                    if not r.done:            # max_new_tokens == 0 edge
                        r.done = True
                        r.latency_s = dt
                    finished.append(r)
        return finished
