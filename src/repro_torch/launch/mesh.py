"""Mesh builders, as ``repro.launch.mesh``: a ``DeviceMesh`` with named axes.

Functions, not module-level constants: importing this module never starts a
process group.  The production target of the reference is a pod of
16 x 16 = 256 chips, and multi-pod doubles it with a leading ``"pod"`` axis
(2 x 256 = 512 chips).

Three kinds of mesh:

  * ``make_mesh(shape, axes, device=None)`` builds a ``DeviceMesh`` over the
    initialised world, on the card unless the caller asks for the CPU.  The
    mesh must be the world: a shape whose product differs from the world
    size raises (several cards are ROADMAP Queue 1 item 4), it never shrinks.
    With no process group and a shape of one device, it starts a world of one
    itself (NCCL on the card, gloo on the CPU), as the reference's
    ``make_host_mesh`` needs no setup;
  * ``make_abstract_mesh(shape, axes)`` is a device-free description (axis
    names and sizes), which the sharding functions accept as the reference's
    accept ``AbstractMesh``;
  * ``fake_mesh(shape, axes)`` builds a mesh of any size on torch's
    ``"fake"`` process-group backend (no peers, every collective returns at
    once), which is what the dry-run lowers on; it refuses when a real
    process group is up and always destroys its own on exit.

``enter_mesh`` opens a CLI's ``--mesh`` and binds its rules.
``axis_sizes(mesh)`` reads ``{axis name: size}`` from either kind (a
``DeviceMesh``'s ``shape`` is a tuple, not the reference's name -> size map).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import sys
from typing import Dict, Iterator, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

#: the production meshes (ROADMAP: one pod of 16 x 16, two pods)
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}

#: the serve and train CLIs' mesh axes
AXES = ("data", "model")

#: what a mesh larger than the one card needs
SEVERAL_CARDS = ("several cards (ROADMAP Queue 1 item 4, multi-card NCCL "
                 "collectives)")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices: the reference's ``AbstractMesh``."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_abstract_mesh(shape: Tuple[int, ...],
                       axes: Tuple[str, ...]) -> AbstractMesh:
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    return AbstractMesh(tuple(int(s) for s in shape), tuple(axes))


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def mesh_size(mesh) -> int:
    return math.prod(axis_sizes(mesh).values())


def parse_mesh(name: str) -> Tuple[int, ...]:
    """``"2x1"`` -> (2, 1); raises ``ValueError`` on anything else."""
    try:
        dims = tuple(int(d) for d in name.split("x"))
    except ValueError:
        raise ValueError(f"mesh {name!r} is not of the form AxB") from None
    if not dims or min(dims) < 1:
        raise ValueError(f"mesh {name!r} has an axis below 1")
    return dims


def _start_world_of_one(dev: torch.device) -> None:
    """A process group of one rank, started here: NCCL on the card, gloo on
    the CPU, over an in-process store (no port, no peer)."""
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: DeviceLike = None):
    """A ``DeviceMesh`` of ``shape`` over the world, on ``device`` (None:
    the card).  The mesh is the world: a shape whose product is not the
    world size raises ``ValueError`` naming what it needs."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    n = math.prod(shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"a {'x'.join(map(str, shape))} mesh needs {n} ranks and no "
                f"process group is up: start one per device (torchrun) on "
                f"the CPU; on the card this needs {SEVERAL_CARDS}")
        _start_world_of_one(dev)
    world = dist.get_world_size()
    if n != world:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh needs {n} devices and the "
            f"world has {world}; the mesh must be the world (as many ranks "
            f"under torchrun on the CPU; on the card {SEVERAL_CARDS})")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def open_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: DeviceLike = None) -> Iterator:
    """``make_mesh`` for an entry point: with no process group up, joins
    the world ``torchrun`` describes (``WORLD_SIZE`` > 1: gloo on the CPU,
    NCCL on cards) or lets ``make_mesh`` start a world of one; on exit it
    takes down the group it started, so a caller's process is left as it
    was (a test's, for one)."""
    dev = resolve_device(device)
    started = not dist.is_initialized()
    if started and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    try:
        yield make_mesh(shape, axes, device=dev)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def enter_mesh(stack: contextlib.ExitStack, name: str, cfg,
               device: DeviceLike = None):
    """Open a CLI's ``--mesh`` (``DxM`` over ``AXES``) in ``stack`` and bind
    ``distributed.sharding.cli_rules`` on it (with DTensor's implicit
    replication of plain tensors when the mesh spans more than one device);
    returns the mesh, or None after printing why the mesh cannot be had
    (the CLI exits 2)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import cli_rules, use_sharding
    try:
        dims = parse_mesh(name)
        if len(dims) != len(AXES):
            raise ValueError(f"want DxM over {AXES}, got {name!r}")
        mesh = stack.enter_context(open_mesh(dims, AXES, device=device))
    except ValueError as e:
        print(f"--mesh {name}: {e}", file=sys.stderr)
        return None
    stack.enter_context(use_sharding(mesh, cli_rules(cfg, mesh)))
    if mesh_size(mesh) > 1:
        stack.enter_context(implicit_replication())
    return mesh

def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    shape, axes = PRODUCTION[multi_pod]
    return make_mesh(shape, axes, device=device)


def make_host_mesh():
    """Single-device mesh on the CPU (smoke tests): both axes size 1."""
    return make_mesh((1, 1), ("data", "model"), device="cpu")


@contextlib.contextmanager
def fake_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Iterator:
    """A CPU ``DeviceMesh`` of ``shape`` on the ``"fake"`` backend, for the
    dry-run: this process is rank 0 of a world of ``prod(shape)`` whose
    collectives move nothing.  Refuses when a process group is already up
    (a real world would be shadowed); destroys its own on exit, even on an
    error, so no fake world outlives the block.

    The mesh is a CPU one on any host (autograd refuses fake CUDA tensors
    in a CPU build); ``distributed.sharding.shard_hint`` moves a shard
    from one dim to another on a CPU mesh by all-to-all, as DTensor does
    on a CUDA one."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(
            "fake_mesh: a process group is already up; the dry-run builds "
            "its fake world only in a process that has none")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))
    finally:
        dist.destroy_process_group()
