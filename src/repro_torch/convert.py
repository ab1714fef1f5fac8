"""Carry state across from the reference's arrays, and back to numpy.

The port imports nothing of the JAX package, so these functions take
anything array-like with the reference's field names (its NamedTuples
hold JAX arrays, which ``np.asarray`` reads) and build the port's
NamedTuples of tensors on ``device``: floats as float32, ids and
counters as int32, exactly as the reference stores them.

``lm_params`` carries an LM parameter tree across, whatever its leaves
(an MLA layer's ``w_dq`` .. ``wo`` as a GQA layer's, a MoE layer's
router and stacked experts; each leaf keeps its
float32 or bfloat16 type, so a bf16 Mamba-2 tree keeps its float32
``A_log``, ``D`` and ``dt_bias`` and a bf16 hybrid its float32
``Lambda``), ``lm_caches`` the LM's prefill and decode caches (over
stages and units of mixed kinds, as ``lm_params``), ``encdec_params`` /
``encdec_caches`` the encoder-decoder's tree and its decoder caches
(``lm_params`` / ``lm_caches`` hand an encoder-decoder config to
them), ``protocol_state`` a protocol's carry and
``train_state`` the LM trainer's whole state; ``to_numpy`` reads the
port's structures back, bfloat16 widened to float32 (exact).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import device as device_mod
from .core.learners import KernelLearnerState, LinearLearnerState
from .core.protocol import ProtocolState
from .core.rff import RFFLearnerState, RFFSpec
from .core.rkhs import SVModel
from .launch.train import TrainState
from .models.attention import KVCache, MLACache
from .models.rglru import LRUState
from .models.ssm import SSMState
from .tree import tree_map


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(np.array(v, dtype=np.float32), device=device)


def _i32(v, device) -> torch.Tensor:
    return torch.as_tensor(np.array(v, dtype=np.int32), device=device)


def sv_model(model: Any, device=None) -> SVModel:
    """An (optionally stacked) ``SVModel`` from (sv, alpha, sv_id)."""
    return SVModel(sv=_f32(model.sv, device), alpha=_f32(model.alpha, device),
                   sv_id=_i32(model.sv_id, device))


def kernel_learner_state(state: Any, device=None) -> KernelLearnerState:
    """A (stacked) ``KernelLearnerState`` from (model, counter, learner_id)."""
    return KernelLearnerState(model=sv_model(state.model, device),
                              counter=_i32(state.counter, device),
                              learner_id=_i32(state.learner_id, device))


def linear_state(state: Any, device=None) -> LinearLearnerState:
    return LinearLearnerState(w=_f32(state.w, device), b=_f32(state.b, device))


def rff_state(state: Any, device=None) -> RFFLearnerState:
    return RFFLearnerState(w=_f32(state.w, device), b=_f32(state.b, device))


def rff_spec(spec: Any, W, b) -> RFFSpec:
    """The port's ``RFFSpec`` for a reference spec (dim, num_features,
    gamma, seed) with the reference's own draw ``(W, b)``."""
    return RFFSpec(dim=int(spec.dim), num_features=int(spec.num_features),
                   gamma=float(spec.gamma), seed=int(spec.seed),
                   W=np.asarray(W, dtype=np.float32),
                   b=np.asarray(b, dtype=np.float32))


_FLOAT_TYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _leaf(x, device) -> torch.Tensor:
    """A float leaf in its own type.  A JAX bfloat16 array reads as an
    ``ml_dtypes`` array, which torch cannot take: it goes through
    float32, and back to bfloat16, which is exact."""
    kind = str(np.asarray(x).dtype)
    if kind not in _FLOAT_TYPES:
        raise TypeError(f"parameter of type {kind}")
    t = torch.as_tensor(np.array(x, np.float32), device=device)
    return t.to(_FLOAT_TYPES[kind])


def _tree(t, fn):
    if isinstance(t, dict):
        return {k: _tree(v, fn) for k, v in t.items()}
    return fn(t)


def _layers(cfg, stages) -> list:
    """(stage, repeat, unit index, kind) of each layer in
    ``cfg.pattern``'s order: unit j of repeat r in stage s is layer
    ``sum of the earlier stages' layers + r len(unit) + j``.  Checks that
    the reference's stages are ``cfg.stages``'."""
    out = []
    for s, (unit, repeats) in enumerate(cfg.stages):
        out += [(s, r, j, kind) for r in range(repeats)
                for j, kind in enumerate(unit)]
    if [kind for *_, kind in out] != list(cfg.pattern) \
            or len(stages) != len(cfg.stages) \
            or any(sorted(st) != [f"b{j}" for j in range(len(unit))]
                   for st, (unit, _) in zip(stages, cfg.stages)):
        raise ValueError(f"the reference's stages do not match "
                         f"{cfg.stages}")
    return out


def lm_params(params: Any, cfg, device=None, stacked: bool = False) -> dict:
    """The port's LM parameters from the reference's tree
    (``repro.models.build(cfg).init``): ``embed``, ``final_norm``,
    ``lm_head`` when untied, and each stage's units unstacked into
    ``layers``, one dict per layer in pattern order (``_layers``).  With
    ``stacked`` every leaf carries a leading learner axis first (the
    trainer's layout).  ``device=None`` is the CUDA card."""
    if cfg.is_encdec:
        return encdec_params(params, cfg, device, stacked)
    dev = device_mod.resolve(device)
    layers = _layers(cfg, params["stages"])
    repeat_axis = 1 if stacked else 0
    units = {(s, j): _tree(params["stages"][s][f"b{j}"], np.asarray)
             for s, _, j, _ in layers}
    out = {k: _tree(params[k], lambda x: _leaf(x, dev))
           for k in ("embed", "final_norm", "lm_head") if k in params}
    out["layers"] = [
        _tree(units[s, j],
              lambda x, r=r: _leaf(np.take(x, r, axis=repeat_axis), dev))
        for s, r, j, _ in layers]
    return out


_CACHES = {"attn": KVCache, "mla": MLACache, "ssm": SSMState,
           "rglru": LRUState}


def lm_caches(caches: Any, cfg, device=None) -> list:
    """The port's per-layer caches from the reference's stacked
    per-stage ones (``init_caches`` / ``prefill`` / ``decode_step``):
    each stage's units unstacked into one ``KVCache`` (``MLACache`` for
    MLA), ``SSMState`` or ``LRUState`` a layer in pattern order, each leaf in its own type
    (``slot_pos`` as int32), so a prefill or a decode can start from a
    JAX state."""
    if cfg.is_encdec:
        return encdec_caches(caches, cfg, device)
    dev = device_mod.resolve(device)
    out = []
    for s, r, j, kind in _layers(cfg, caches):
        stack = caches[s][f"b{j}"]
        if kind in ("attn", "moe"):
            kind = "mla" if cfg.attn_kind == "mla" else "attn"
        fields = _CACHES[kind]._fields
        out.append(_CACHES[kind](*(
            _array(np.take(np.asarray(getattr(stack, f)), r, axis=0), dev)
            for f in fields)))
    return out


def encdec_params(params: Any, cfg, device=None,
                  stacked: bool = False) -> dict:
    """The port's encoder-decoder parameters from the reference's tree
    (``init_encdec``): ``enc_blocks`` / ``dec_blocks``, stacked by
    ``vmap`` there, unstacked into one dict a layer; every other entry
    leaf by leaf.  ``stacked``: a leading learner axis on every leaf."""
    dev = device_mod.resolve(device)
    axis = 1 if stacked else 0
    counts = {"enc_blocks": cfg.encoder_layers, "dec_blocks": cfg.n_layers}
    out = {}
    for key, tree in params.items():
        if key in counts:
            tree = _tree(tree, np.asarray)
            out[key] = [_tree(tree, lambda x, r=r: _leaf(
                np.take(x, r, axis=axis), dev)) for r in range(counts[key])]
        else:
            out[key] = _tree(tree, lambda x: _leaf(x, dev))
    return out


def encdec_caches(caches: Any, cfg, device=None) -> list:
    """The port's decoder caches from the reference's
    (``init_dec_caches`` / ``prefill_decoder`` / ``decode_step_encdec``:
    ``self`` a ``KVCache`` and ``cross_k`` / ``cross_v``, each stacked
    over the decoder layers): one dict a layer."""
    dev = device_mod.resolve(device)
    self_c = caches["self"]
    out = []
    for r in range(cfg.n_layers):
        def take(x, r=r):
            return _array(np.take(np.asarray(x), r, axis=0), dev)
        out.append({"self": KVCache(*(take(getattr(self_c, f))
                                      for f in KVCache._fields)),
                    "cross_k": take(caches["cross_k"]),
                    "cross_v": take(caches["cross_v"])})
    return out


def _array(x, device) -> torch.Tensor:
    """One array in its own type: a float as float32 or bfloat16 (see
    ``_leaf``), an integer as int32, a bool as bool."""
    kind = str(np.asarray(x).dtype)
    if kind in _FLOAT_TYPES:
        return _leaf(x, device)
    if kind == "bool":
        return torch.as_tensor(np.array(x, dtype=bool), device=device)
    return _i32(x, device)


def protocol_state(pstate: Any, device=None, reference=None):
    """The port's ``ProtocolState`` from the reference's: the counters in
    the reference's types (int32 step and syncs, float32 bytes,
    divergence and scale) and the reference model through
    ``reference(tree, device)`` (default: leaf by leaf, each in its own
    type)."""
    dev = device_mod.resolve(device)
    ref = (reference(pstate.reference, dev) if reference
           else tree_map(lambda x: _array(x, dev), pstate.reference))
    return ProtocolState(reference=ref, step=_i32(pstate.step, dev),
                         syncs=_i32(pstate.syncs, dev),
                         bytes_sent=_f32(pstate.bytes_sent, dev),
                         last_divergence=_f32(pstate.last_divergence, dev),
                         delta_scale=_f32(pstate.delta_scale, dev))


def train_state(state: Any, cfg, device=None):
    """The port's ``launch.train.TrainState`` from the reference's:
    stacked parameters (``lm_params(stacked=True)``), the optimizer's
    state (``()``, a parameter-shaped tree, or adamw's ``{"m", "v"}``),
    the protocol state with its stacked reference, and the step."""
    dev = device_mod.resolve(device)

    def lm(tree, d=dev):
        return lm_params(tree, cfg, d, stacked=True)

    opt = state.opt
    if isinstance(opt, dict) and set(opt) == {"m", "v"}:
        opt = {k: lm(v) for k, v in opt.items()}
    elif opt != ():
        opt = lm(opt)
    return TrainState(params=lm(state.params), opt=opt,
                      pstate=protocol_state(state.pstate, dev, lm),
                      step=_i32(state.step, dev))


def to_numpy(tree: Any):
    """A NamedTuple, dict or list of tensors (nested) as the same
    structure of numpy arrays (bfloat16 as float32); a lone tensor as an
    array."""
    if torch.is_tensor(tree):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree
