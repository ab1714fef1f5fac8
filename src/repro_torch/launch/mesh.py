"""The learner mesh (port of ``repro/launch/mesh.py``'s learner half).

The reference shards the learner axis over a ``jax.sharding.Mesh`` and
runs ONE program on it (``shard_map``): a single controller.  The port
keeps that design: a :class:`LearnerMesh` is a tuple of devices, one
per shard, and one process drives every shard.  Several shards may
share one card, as the reference's tests put 8 shards on one CPU;
with more than one card shard k sits on ``cuda:(k mod cards)``.

The engine (``core/engine.py``) runs each shard's rounds on its own
device with its own kernel launches; a synchronization gathers the
shards' models on the lead shard (shard 0) in learner order and runs
the single-device sync there.  No float is reduced across shards, so
a mesh run equals the single-device run bitwise.

The reference's production meshes (``make_production_mesh``,
``make_host_mesh``) and its TPU hardware constants are not part of
the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from .. import device as device_mod

LEARNER_AXIS = "learners"


def resolve_device(dev) -> torch.device:
    """``device.resolve`` with a CUDA device's index filled in, so a
    shard's device compares equal to its tensors' devices."""
    dev = device_mod.resolve(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class LearnerMesh:
    """A 1-D mesh with the ``learners`` axis over ``devices`` (shard k
    on ``devices[k]``).  Frozen and hashable."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (LEARNER_AXIS,)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a learner mesh needs at least one device")
        if self.axis_names != (LEARNER_AXIS,):
            raise ValueError(f"a learner mesh has the one axis "
                             f"{LEARNER_AXIS!r}, got {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return {LEARNER_AXIS: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_learner_mesh(n: int = 0,
                      devices: Optional[Sequence] = None) -> LearnerMesh:
    """A :class:`LearnerMesh` of n shards (the reference's
    ``make_learner_mesh``).

    Without ``devices`` shard k sits on ``cuda:(k mod
    torch.cuda.device_count())`` and ``n=0`` means every visible card;
    a machine without CUDA raises, as ``device.resolve`` does.
    ``devices`` places the shards explicitly: ``["cpu"] * 4`` puts four
    shards on the CPU, ``["cuda:0"] * 4`` four shards on one card.
    """
    if devices is not None:
        devs = tuple(resolve_device(d) for d in devices)
        if n and n != len(devs):
            raise ValueError(f"n={n} shards but {len(devs)} devices")
        return LearnerMesh(devices=devs)
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    device_mod.resolve("cuda")          # raises without CUDA
    cards = torch.cuda.device_count()
    n = n or cards
    return LearnerMesh(devices=tuple(torch.device("cuda", k % cards)
                                     for k in range(n)))


def data_axes(mesh) -> Tuple[str, ...]:
    """The learner/batch axes of a mesh (everything except 'model')."""
    return tuple(a for a in mesh.axis_names if a != "model")


def num_learners(mesh) -> int:
    """Shards along the learner/batch axes."""
    return math.prod(mesh.shape[a] for a in data_axes(mesh))


def learner_axes_of(mesh) -> Tuple[str, ...]:
    """The mesh axes the learner dim is sharded over: ``learners`` when
    the mesh has it, otherwise every axis except ``model`` (the
    reference's ``engine.learner_axes_of``)."""
    if LEARNER_AXIS in mesh.axis_names:
        return (LEARNER_AXIS,)
    axes = data_axes(mesh)
    if not axes:
        raise ValueError(
            f"mesh {mesh.axis_names} has no learner axis; name one "
            "'learners' or include a non-'model' axis")
    return axes
