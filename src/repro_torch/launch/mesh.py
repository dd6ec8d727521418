"""Rank worlds and meshes over ``torch.distributed``.

Port of ``src/repro/launch/mesh.py``. The reference builds a
``jax.sharding.Mesh`` over the devices one process sees; in the port a
device is a rank (one process), and a mesh is a process-group layout
over the ranks of a world, with the reference's axis names.

  * **The mesh** (:class:`Mesh`) holds the placement's shape and axis
    names, this rank's coordinates (rank ``r`` sits at
    ``unravel_index(r, shape)``, the reference's device-major order) and
    one process group per axis and one for the data-parallel axes
    together. Meshes carry ``data`` and ``model`` always, as
    ``Placement.mesh_shape`` / ``mesh_axes`` do. A mesh of one rank has
    no groups and its collectives are the identity.
  * **Starting ranks.** :func:`init_world` joins a world either from the
    environment that ``launch/slurm.py`` renders (``RANK``,
    ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``) or
    from a ``FileStore`` file the caller names; :func:`spawn` starts the
    ranks of a world as fresh local processes on such a file and returns
    what each rank's function returned.
  * **The backend follows the device**: ``nccl`` for ``cuda``, one card
    a rank, rank ``r`` on card ``LOCAL_RANK``; ``gloo`` for ``cpu``. A
    caller may name ``backend="gloo"`` on ``cuda`` to put several ranks
    on one card. An ``nccl`` world larger than the card count raises,
    naming both counts; nothing switches the backend or the device
    silently.
  * **No hangs.** Every process group has a timeout of
    :data:`GROUP_TIMEOUT_S`, so a collective waiting on a dead peer
    raises; :func:`spawn` terminates every rank as soon as one
    raises or dies, and re-raises its traceback.

The reference's ``make_production_mesh`` (256 and 512 chips) is ROADMAP
Queue 1 item 8.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.core import tree
from repro_torch.device import DeviceLike, resolve_device

#: the longest a process group waits on a peer, seconds
GROUP_TIMEOUT_S = 120


# ---------------------------------------------------------------------------
# Worlds
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class World:
    """One rank's view of its world."""

    rank: int
    world_size: int
    local_rank: int
    backend: str
    device: torch.device


def backend_for(device: torch.device, backend: Optional[str] = None) -> str:
    """``nccl`` on ``cuda`` and ``gloo`` on ``cpu`` unless the caller names
    one; ``nccl`` on the CPU raises."""
    if backend is None:
        return "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: expected 'nccl' or 'gloo'")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"backend nccl needs cuda devices, not {device}")
    return backend


def check_world(backend: str, device: torch.device, world_size: int) -> None:
    """An ``nccl`` world needs a card a rank: raise when it is larger than
    the card count."""
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise RuntimeError(
            f"an nccl world of {world_size} ranks needs {world_size} cards, "
            f"this machine has {torch.cuda.device_count()}; a gloo world "
            f"(launch.mesh.spawn(..., backend='gloo')) puts several ranks "
            f"on one card")


def env_world_size() -> int:
    """``WORLD_SIZE`` of the environment (1 when unset)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_world(device: DeviceLike = None, *, backend: Optional[str] = None,
               rank: Optional[int] = None,
               world_size: Optional[int] = None,
               store_path: Optional[str] = None) -> World:
    """Join a world and return this rank's :class:`World`.

    ``rank`` / ``world_size`` default to the environment's ``RANK`` /
    ``WORLD_SIZE`` (``LOCAL_RANK`` picks the card; the rendezvous is
    ``MASTER_ADDR`` / ``MASTER_PORT``); ``store_path`` names a
    ``FileStore`` file instead. ``device`` defaults to the card."""
    dev = resolve_device(device)
    backend = backend_for(dev, backend)
    if rank is None:
        rank = int(os.environ["RANK"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    else:
        local_rank = rank
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    check_world(backend, dev, world_size)
    if dev.type == "cuda":
        # nccl: a card a rank; gloo: every rank on the card it was given
        idx = local_rank if backend == "nccl" else (dev.index or 0)
        dev = torch.device("cuda", idx)
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    if store_path is not None:
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world_size, timeout=timeout)
    return World(rank, world_size, local_rank, backend, dev)


def _rank_main(rank, world_size, store_path, device, backend, fn, args,
               results):
    # ranks share the host's cores: each takes its share of the threads
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        world = init_world(device, backend=backend, rank=rank,
                           world_size=world_size, store_path=store_path)
        out = fn(world, *args)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - reported to the parent, re-raised there
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, *, args: Sequence = (),
          device: DeviceLike = None, backend: Optional[str] = None,
          rendezvous: Optional[str] = None) -> list:
    """Run ``fn(world, *args)`` in ``world_size`` fresh processes, one a
    rank, and return each rank's result in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by its import path);
    ``rendezvous`` is the ``FileStore`` file (a fresh temporary one by
    default); ``device`` defaults to the card. A rank that raises or
    dies ends the call: every other rank is terminated and a
    ``RuntimeError`` carries the rank's traceback. A rank waiting on a
    dead peer raises within :data:`GROUP_TIMEOUT_S`."""
    dev = resolve_device(device)
    check_world(backend_for(dev, backend), dev, world_size)
    tmp = None
    if rendezvous is None:
        tmp = tempfile.mkdtemp(prefix="repro_torch_rdzv_")
        rendezvous = os.path.join(tmp, "store")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, rendezvous, str(dev), backend,
                               fn, tuple(args), results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    got: dict = {}
    try:
        while len(got) < world_size:
            try:
                rank, ok, payload = results.get(timeout=0.5)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in got and p.exitcode is not None:
                        raise RuntimeError(
                            f"rank {r} of {world_size} exited with code "
                            f"{p.exitcode} before it reported")
                continue
            if not ok:
                time.sleep(0.5)     # a peer that died first is the cause
                dead = [f"rank {r} of {world_size} exited with code "
                        f"{p.exitcode} before it reported"
                        for r, p in enumerate(procs)
                        if r != rank and p.exitcode not in (None, 0)]
                raise RuntimeError("; ".join(dead + [
                    f"rank {rank} of {world_size} failed:\n{payload}"]))
            got[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=10 if len(got) == world_size else 0)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(world_size)]


def group_size(group) -> int:
    """Ranks of ``group`` (None: a world of one)."""
    return 1 if group is None else dist.get_world_size(group)


def all_mean(t: torch.Tensor, group) -> torch.Tensor:
    """fp32 mean of ``t`` over ``group`` (a new tensor; ``t`` itself for
    a world of one)."""
    if group is None:
        return t
    t = t.float().clone()
    dist.all_reduce(t, group=group)
    return t / group_size(group)


def pmean(values: list, group) -> list:
    """Means over ``group`` of 0-d tensors, in one all-reduce."""
    if group is None or not values:
        return values
    return list(all_mean(torch.stack([v.float() for v in values]), group))


def dp_mean(grads, scalars: list, group) -> tuple:
    """A plain data-parallel step's reduction: the fp32 mean over
    ``group`` of every gradient leaf (one all-reduce a leaf, what GSPMD
    inserts for a replicated gradient) and of the 0-d ``scalars`` (one
    all-reduce). Returns ``(grads, scalars)``."""
    with record_function("grad_sync"):
        grads = tree.tree_map(lambda g: all_mean(g.float(), group), grads)
    return grads, pmean(scalars, group)


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------


class Mesh:
    """A placement's axes over the ranks of the current world.

    ``shape`` maps axis name to size in axis order (as a jax mesh's
    ``shape``), ``axis_names`` is their order, ``coords`` this rank's
    index on each axis. The world must hold exactly ``prod(shape)``
    ranks; with no process group initialized the mesh must be of one
    rank. Building a mesh is collective: every rank builds the same
    mesh at the same point."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        shape, axes = tuple(int(n) for n in shape), tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} vs axes {axes}")
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes
        self.size = math.prod(shape)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != self.size:
            raise ValueError(
                f"mesh {dict(self.shape)} needs {self.size} ranks, the world "
                f"has {world}")
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.coords = dict(zip(axes, (int(i) for i in
                                      np.unravel_index(self.rank, shape))))
        self._groups: dict = {}
        for sub in [(a,) for a in axes] + [dp_axes(self)]:
            if sub not in self._groups:
                self._groups[sub] = self._make_group(sub)

    def _make_group(self, sub: tuple):
        """``(group, ranks)`` of this rank's block along ``sub``; every
        rank creates every block's group, in the same order."""
        grid = np.arange(self.size).reshape(tuple(self.shape.values()))
        idx = [self.axis_names.index(a) for a in sub]
        rest = [i for i in range(len(self.axis_names)) if i not in idx]
        blocks = grid.transpose(rest + idx).reshape(
            -1, math.prod(self.shape[a] for a in sub))
        if blocks.shape[1] == 1:
            return None, [self.rank]
        mine = None
        for row in blocks:
            ranks = [int(r) for r in row]
            g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = (g, ranks)
        return mine

    def _entry(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if axes not in self._groups:
            raise KeyError(f"mesh has no group over {axes}; it has "
                           f"{sorted(self._groups)}")
        return self._groups[axes]

    def group(self, axes):
        """The process group over ``axes`` holding this rank (None when
        the axes have one rank)."""
        return self._entry(axes)[0]

    def ranks(self, axes) -> list:
        """Global ranks of this rank's group over ``axes``, in order."""
        return self._entry(axes)[1]

    def axes_size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape.get(a, 1) for a in axes)

    def index(self, axes) -> int:
        """This rank's position in its group over ``axes``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.ravel_multi_index(
            [self.coords[a] for a in axes],
            [self.shape[a] for a in axes]))

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, rank={self.rank})"


def make_mesh(shape, axes) -> Mesh:
    """Arbitrary mesh helper (tests, pipeline-parallel experiments)."""
    return Mesh(shape, axes)


def mesh_for(placement) -> Mesh:
    """Mesh for a ``repro_torch.bench.spec.Placement`` (duck-typed:
    anything with ``mesh_shape`` / ``mesh_axes``)."""
    return Mesh(placement.mesh_shape, placement.mesh_axes)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh (everything except "model")."""
    return tuple(a for a in mesh.axis_names if a != "model")


def axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1
