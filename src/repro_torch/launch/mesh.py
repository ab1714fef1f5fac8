"""Meshes (port of ``repro/launch/mesh.py``): the learner mesh the
engine runs on, the production and host meshes the dry run lays specs
over, and the H100's constants for the roofline.

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

``make_production_mesh`` and ``make_host_mesh`` build a
:class:`NamedMesh`, axes with names and sizes.  The production mesh
holds no device: the port's dry run (``launch/dryrun.py``) reads only
its axes, the per-device shapes a spec implies on them and the learner
count (``num_learners``: 16 on one pod, 32 on two).  The host mesh
spans the visible cards, or the devices given.

The hardware constants are one NVIDIA H100 SXM's, from NVIDIA's data
sheet at its 700 W power limit (dense rates, no sparsity).
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


@dataclasses.dataclass(frozen=True)
class NamedMesh:
    """A mesh of named axes (``axis_names``, ``axis_sizes``), over
    ``devices`` in row-major order, or over none (a production mesh, for
    the dry run).  Frozen and hashable."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...] = ()

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes) \
                or len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axes {self.axis_names} of sizes "
                             f"{self.axis_sizes}")
        if any(n < 1 for n in self.axis_sizes):
            raise ValueError(f"axis sizes {self.axis_sizes}")
        if self.devices and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> NamedMesh:
    """(data 16, model 16) = 256 devices, or (pod 2, data 16, model 16)
    = 512, with no device behind them."""
    if multi_pod:
        return NamedMesh(("pod", "data", "model"), (2, 16, 16))
    return NamedMesh(("data", "model"), (16, 16))


def make_host_mesh(data: int = 1, model: int = 1,
                   devices: Optional[Sequence] = None) -> NamedMesh:
    """A (data, model) mesh over the first data x model of the visible
    cards, or of ``devices`` (``["cpu"] * 4``: four on the CPU).  Raises
    where there are fewer, and without ``devices`` on a machine without
    CUDA, as ``device.resolve`` does."""
    if devices is None:
        device_mod.resolve("cuda")          # raises without CUDA
        devs = tuple(torch.device("cuda", k)
                     for k in range(torch.cuda.device_count()))
    else:
        devs = tuple(resolve_device(d) for d in devices)
    if data * model > len(devs):
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"devices, {len(devs)} given")
    return NamedMesh(("data", "model"), (data, model),
                     devs[:data * model])


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


# Hardware constants for the roofline (one NVIDIA H100 SXM, data sheet,
# 700 W): dense bf16 tensor-core peak and HBM3 bandwidth.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s per card
HBM_BW = 3.35e12                # bytes/s per card
# NVLink 4: 900 GB/s a card over its 18 links, both directions summed,
# so 450 GB/s a card in each direction.  The roofline's collective term
# divides one device's collective bytes by this per-card figure.
LINK_BW = 450e9                 # bytes/s per card, one direction
