"""Dry run of every (arch x shape) cell for one H100: counted, not run.

Port of ``src/repro/launch/dryrun.py``. For every cell it

  1. builds the cell's inputs as ``meta`` tensors (``launch.specs``):
     shapes and dtypes, no storage, no card;
  2. traces the cell's programs on them: the train step (each
     microbatch's ``value_and_grad`` under ``remat="full"``, recompute
     included, the gradient accumulation and the optimizer update), the
     prefill (``impl="repeat"``) or the grouped decode step;
  3. counts, while they trace, the matmul FLOPs (by the formulas of
     ``torch.utils.flop_counter``), the bytes each op reads and writes,
     and the live bytes of every storage, in one dispatch mode
     (:class:`Tally`);
  4. writes one JSON record per cell under ``artifacts/dryrun_torch/``
     with the one-H100 roofline (``roofline.analysis``).

What the counts mean:

- ``cost_analysis.flops`` are the matmul FLOPs (``mm``, ``bmm``, the
  einsums that lower to them), the ``dot_general`` FLOPs of the
  reference's programs; elementwise arithmetic is not counted.
- ``cost_analysis.bytes_accessed`` sums every op's inputs and outputs as
  if no two ops were fused: an upper bound on the HBM traffic, where
  XLA's figure is that of its fused program. View ops move no bytes.
- ``bytes_per_device`` is the peak of the live storages, each rounded up
  to the CUDA caching allocator's 512-byte blocks: the inputs (params,
  optimizer state, batch, caches) and whatever the program makes. It
  estimates ``torch.cuda.max_memory_allocated`` of a real step, which
  :func:`real_step` measures on the card. A train cell's peak is that of
  the step over at most two microbatches, plus the rest of the batch.
- Every program is traced at full depth. The reference extrapolates
  its counts from programs of one and two layer periods because XLA is
  slow to unroll; on ``meta`` a full-depth trace takes seconds (the
  q-chunked 32k prefill of a 48-layer model about a minute), and the
  peak is not affine in the depth: it is the largest of several
  affine events (a layer's transients above the caches so far, the
  caches stacked at the end), so an extrapolation misses it where the
  largest event changes with depth (from one and two periods mamba2's
  decode_32k peak came out 74 % high, qwen2-0.5b's prefill_32k 43 %;
  from two and three, still off at reduced sizes). FLOPs and bytes are
  affine: ``cell_counts(..., full_depth=False)`` extrapolates them
  from ``EXTRAPOLATE_FROM`` and one more periods, and the tests hold
  that equal to the full-depth count.

The production meshes. ``--mesh single|multi|both`` counts the
reference's 256-card ``(16, 16)`` and 512-card ``(2, 16, 16)`` meshes
(:func:`make_production_mesh`) by tracing **rank 0's program**
on ``meta``: the plan of the cell (``parallel.sharding.make_plan``),
every input at rank 0's local shape (``launch.specs`` with the plan:
param shards, optimizer slices, batch rows, caches by ``cache_spec``),
and a :class:`CountingMesh` in the place of the process groups:
each collective returns a ``meta`` tensor of its result's shape and is
recorded with its group size and ring wire bytes
(``roofline.hlo.CollectiveStats``), and the link its group takes (8
cards a node, ranks row-major: a group inside one node on NVLink, one
across nodes on the network; the 16-wide ``model`` axis spans two
nodes). The microbatch rule is the reference's for a mesh (the paper's
4 rows, 1 for FSDP or > 16 B params, 2 above 4 B, per dp rank); a train
step of k > 2 microbatches is counted from traces of one and two and
extrapolated (every count is affine in k), its peak from two. The
multi pass, as in the reference, is memory only: one trace of at most
two microbatches, its counts scaled by k over their number;
``--no-metrics`` takes that pass on every mesh (on ``1xh100`` a train
step's bytes are then its trace's scaled by k over its microbatches,
without the gradient buffers' own traces), and each record says which
pass it took (``metrics_pass``). The collective term takes each group's
link bandwidth (``roofline.analysis``).

Not carried over: the XLA compile and its ``memory_analysis``, the
collective parse of the compiled HLO (``roofline.hlo``), and the XLA:CPU
artefacts ``_cpu_f32_param_dupe_bytes`` and ``bytes_per_device_tpu``
(f32 twins of bf16 weights that XLA:CPU makes and a TPU does not), with
``fits_hbm_16g_raw_cpu``. ``fits_hbm_16g`` becomes ``fits_hbm_80g``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --real qwen2-0.5b:train_4k:4          # a real step, on the card
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \\
      --arch granite-8b --shape train_4k    # rank 0 of 256 cards
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import json
import multiprocessing
import pathlib
import time
import traceback
import weakref
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.configs import ASSIGNED, PAPER_MODELS, SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import tree
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import lm
from repro_torch.models import moe as moe_mod
from repro_torch.models.blocks import period_of
from repro_torch.models.common import dtype_of
from repro_torch.parallel import layout as layout_mod
from repro_torch.parallel import sharding as shd
from repro_torch.roofline import analysis as roof
from repro_torch.roofline.hlo import CollectiveStats, ring_wire_bytes
from repro_torch.serve.cache import slotted_cache
from repro_torch.serve.engine import make_decode_fn, make_prefill_fn
from repro_torch.train.optimizer import OptConfig, opt_init, opt_update
from repro_torch.train.step import StepConfig, batch_axes, make_train_step

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"
MESH = "1xh100"
N_DEV = 1
#: one H100's HBM: 80 GB
HBM_BYTES = 80 * 10**9
#: the CUDA caching allocator's block granularity
BLOCK = 512
#: the attention formulation of each program (the reference's defaults)
IMPL = {"train": "repeat", "prefill": "repeat", "decode": "grouped"}
#: periods the FLOPs and bytes are extrapolated from (and that number
#: plus one) when the depth is not counted whole
EXTRAPOLATE_FROM = 2
#: the reference's production meshes, by name: multi-pod or not
PRODUCTION = {"single": False, "multi": True}


class Tally(TorchDispatchMode):
    """Sums the FLOPs of every op that ``torch.utils.flop_counter`` has a
    formula for (the matmuls) and the bytes every op reads and writes
    (views none), and tracks the live bytes of every storage it has
    seen, and their peak. ``inputs``: tensors that exist before the
    program (live from the start). One mode, where a
    ``FlopCounterMode`` beside it would add its own dispatch to every
    op; :func:`real_step` holds the two counts equal on the card."""

    def __init__(self, inputs=()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._refs: dict[int, tuple[weakref.ref, int]] = {}
        for t in tree_leaves(inputs):
            if isinstance(t, torch.Tensor):
                self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        n = -(-st.nbytes() // BLOCK) * BLOCK
        self._refs[key] = (weakref.ref(st, functools.partial(self._free, key)),
                           n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key: int, _ref) -> None:
        entry = self._refs.pop(key, None)
        if entry is not None:
            self.live -= entry[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not func.is_view:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            self._track(t)
        return out


@dataclasses.dataclass
class Counts:
    flops: float = 0.0
    bytes: float = 0.0
    peak: float = 0.0

    def __add__(self, o: "Counts") -> "Counts":
        return Counts(self.flops + o.flops, self.bytes + o.bytes,
                      self.peak + o.peak)

    def __sub__(self, o: "Counts") -> "Counts":
        return Counts(self.flops - o.flops, self.bytes - o.bytes,
                      self.peak - o.peak)

    def __mul__(self, w: float) -> "Counts":
        return Counts(self.flops * w, self.bytes * w, self.peak * w)


def count(fn: Callable[[], Any], inputs=()) -> Counts:
    """Run ``fn`` under a :class:`Tally` whose live set starts with
    ``inputs``. Returns its :class:`Counts`."""
    with Tally(inputs) as t:
        fn()
    return Counts(float(t.flops), float(t.bytes), float(t.peak))


def _pick_opt(c: ModelConfig, n_dev: int = N_DEV) -> OptConfig:
    # fp32 Adam + master = 12 B/param; when that alone would exceed half
    # an H100's HBM (spread over n_dev cards), fall back to Adafactor
    # (factored second moment), the reference's rule with the H100's
    # 80 GB in place of v5e's 16 GiB.
    if c.param_count() * 12 / n_dev > HBM_BYTES / 2:
        return OptConfig(name="adafactor")
    return OptConfig()


def microbatching(c: ModelConfig, shape: ShapeConfig,
                  microbatch_size: int = 4) -> tuple[int, int]:
    """(k microbatches, rows a microbatch): the reference's rule, where
    the paper's 4 rows shrink with model size (one device: no FSDP, the
    whole batch on the card)."""
    params_b = c.param_count()
    if params_b > 16e9:
        microbatch_size = 1
    elif params_b > 4e9:
        microbatch_size = min(microbatch_size, 2)
    if shape.kind != "train":
        return 1, shape.global_batch
    k = max(shape.global_batch // microbatch_size, 1)
    return k, shape.global_batch // k


def _depth(c: ModelConfig, n_periods: int,
           n_enc: Optional[int] = None) -> ModelConfig:
    kw = {"n_layers": period_of(c) * n_periods}
    if c.n_enc_layers:
        kw["n_enc_layers"] = n_enc if n_enc is not None else c.n_enc_layers
    return dataclasses.replace(c, **kw)


@contextlib.contextmanager
def _program_ctx(c: ModelConfig, plan=None):
    """The MoE dispatch the reference lowers: the dense one unless the
    plan shards the experts (one device has no expert sharding)."""
    with contextlib.ExitStack() as st:
        if c.n_experts and (plan is None or not plan.ep):
            st.enter_context(moe_mod.moe_impl("dense"))
        yield


def _nbytes(tensors) -> int:
    return sum(-(-t.numel() * t.element_size() // BLOCK) * BLOCK
               for t in tree_leaves(tensors) if isinstance(t, torch.Tensor))


def _train_counts(c: ModelConfig, shape: ShapeConfig, k: int, mb: int,
                  oc: OptConfig, step_overrides: Optional[dict],
                  metrics: bool = True) -> Counts:
    """The train step over ``k`` microbatches of ``mb`` rows at ``c``'s
    depth, from one trace on meta of the step over ``kt = min(k, 2)``
    microbatches (``oc`` is the full model's optimizer: a cut depth must
    not flip its choice). Its peak is the step's (a k-microbatch step
    holds the same buffers; :func:`cell_counts` adds the other
    microbatches' rows); the accumulation and the optimizer do no
    matmul, so the FLOPs are ``k / kt`` times the trace's; the bytes
    are the trace's with ``k - kt`` microbatches more, a microbatch's
    being what is left of the trace once the gradient buffers' traffic
    and the optimizer update (:func:`_grad_buffer_counts`) are taken
    out, and one more accumulation each. ``metrics=False`` (the memory
    pass) scales the trace's bytes by ``k / kt`` instead."""
    sc = StepConfig(microbatches=min(k, 2), remat="full",
                    impl=IMPL["train"], **(step_overrides or {}))
    kt = sc.microbatches
    params = lm.init_abstract(c)
    state = opt_init(oc, params)
    batch = specs_mod.train_batch_specs(
        c, dataclasses.replace(shape, global_batch=kt * mb))
    step = make_train_step(c, oc, sc)
    with _program_ctx(c):
        s = count(lambda: step(params, state, batch), (params, state, batch))
    total = s.bytes
    if k > kt and not metrics:   # the memory pass, as on a mesh
        total *= k / kt
    elif k > kt:   # the buffers' traffic is affine in k from 2 on
        g2, g3 = (_grad_buffer_counts(c, oc, sc, n).bytes for n in (2, 3))
        total += (k - kt) * ((s.bytes - g2) / kt + g3 - g2)
    return Counts(s.flops * k / kt, total, s.peak)


def _grad_buffer_counts(c: ModelConfig, oc: OptConfig, sc: StepConfig,
                        k: int) -> Counts:
    """What the train step does besides its microbatches'
    ``value_and_grad``, traced on meta gradients in the params' dtypes:
    ``k`` accumulations into the gradient buffer and their average (one
    microbatch: the cast to the buffer's dtype), then the optimizer
    update."""
    params = lm.init_abstract(c)
    state = opt_init(oc, params)
    gdt = getattr(torch, sc.grad_dtype)
    grads = tree.tree_map(torch.empty_like, params)

    def run():
        if k <= 1:
            acc = tree.tree_map(lambda g: g.to(gdt), grads)
        else:
            acc = tree.tree_map(lambda p: torch.zeros(
                p.shape, dtype=gdt, device=p.device), params)
            for _ in range(k):
                for a, g in zip(tree.leaves(acc), tree.leaves(grads)):
                    a.add_(g.to(gdt))
            acc = tree.tree_map(lambda g: (g / k).float(), acc)
        opt_update(oc, acc, state, params)

    return count(run, (params, state, grads))


def _serve_counts(c: ModelConfig, shape: ShapeConfig) -> Counts:
    params = lm.init_abstract(c)
    if shape.kind == "prefill":
        tokens, extras = specs_mod.prefill_specs(c, shape)
        fn = make_prefill_fn(c, IMPL["prefill"])
        run = lambda: fn(params, tokens, extras)           # noqa: E731
        inputs = (params, tokens, extras)
    else:
        token, caches, _pos, enc_kv = specs_mod.decode_specs(c, shape,
                                                             params)
        fn = make_decode_fn(c, IMPL["decode"])
        run = lambda: fn(params, token, caches, shape.seq_len - 1,  # noqa
                         enc_kv)
        inputs = (params, token, caches, enc_kv)
    with torch.no_grad(), _program_ctx(c):
        return count(run, inputs)


def cell_counts(c: ModelConfig, shape: ShapeConfig, *,
                microbatch_size: int = 4, step_overrides: Optional[dict] = None,
                full_depth: bool = True,
                metrics: bool = True) -> tuple[Counts, int]:
    """(Counts of the cell's step, microbatches k) for one device.

    Train: the step over k microbatches (:func:`_train_counts`), its
    peak plus the bytes of the other microbatches' rows. Full
    depth by default; ``full_depth=False`` counts a model of more than
    ``EXTRAPOLATE_FROM + 1`` periods at that many periods and one more
    (and, for an encdec model, as many encoder layers and one more) and
    extrapolates, as the reference's metrics pass does. ``metrics=False``
    is the memory pass: the peak is the same, a train step's bytes are
    scaled from its trace (:func:`_train_counts`).
    """
    k, mb = microbatching(c, shape, microbatch_size)
    oc = _pick_opt(c)

    def at(cfg: ModelConfig) -> Counts:
        if shape.kind != "train":
            return _serve_counts(cfg, shape)
        return _train_counts(cfg, shape, k, mb, oc, step_overrides,
                             metrics)

    n = c.n_layers // period_of(c)
    ne = c.n_enc_layers
    if full_depth or (n <= EXTRAPOLATE_FROM + 1
                      and (not ne or ne <= EXTRAPOLATE_FROM + 1)):
        got = at(c)
    else:
        # affine in the periods (and the encoder's layers) from two and
        # three: one period more adds the same ops, and, past the first
        # two, the same live bytes at the peak
        a = EXTRAPOLATE_FROM
        m0 = at(_depth(c, a, a if ne else None))
        got = m0 + (at(_depth(c, a + 1, a if ne else None)) - m0) * (n - a)
        if ne:
            got = got + (at(_depth(c, a, a + 1)) - m0) * (ne - a)
    if shape.kind == "train":
        kt = min(k, 2)
        if k > kt:    # the step holds the whole batch, not kt microbatches
            full = specs_mod.train_batch_specs(c, shape)
            part = specs_mod.train_batch_specs(
                c, dataclasses.replace(shape, global_batch=kt * mb))
            got.peak += _nbytes(full) - _nbytes(part)
    return got, k


def lower_cell(c: ModelConfig, shape: ShapeConfig, mesh_name: str = MESH, *,
               microbatch_size: int = 4,
               step_overrides: Optional[dict] = None,
               plan_overrides: Optional[dict] = None,
               metrics: bool = True) -> dict:
    """Count one cell on ``meta``; return its record (the reference's
    schema, see the module docstring): on one H100, or rank 0 of a
    production mesh (``single``, ``multi``). ``metrics=False`` is the
    reference's ``--no-metrics``: the memory pass, which ``multi``
    always takes (``metrics_pass`` in the record)."""
    if mesh_name in PRODUCTION:
        return sharded_record(c, shape, mesh_name,
                              make_production_mesh(
                                  multi_pod=PRODUCTION[mesh_name]),
                              microbatch_size=microbatch_size,
                              step_overrides=step_overrides,
                              plan_overrides=plan_overrides,
                              metrics=metrics and mesh_name == "single")
    if mesh_name != MESH or plan_overrides:
        raise ValueError(f"mesh {mesh_name!r} (plan {plan_overrides}): "
                         f"one of {[MESH, *PRODUCTION]}; a plan override "
                         f"needs a production mesh")
    t0 = time.time()
    got, k = cell_counts(c, shape, microbatch_size=microbatch_size,
                         step_overrides=step_overrides, metrics=metrics)
    colls = CollectiveStats()
    r = roof.analyze(c, shape, mesh_name=mesh_name, n_devices=N_DEV,
                     flops_per_device=got.flops,
                     hbm_bytes_per_device=got.bytes,
                     wire_bytes_per_device=colls.total_wire_bytes)
    peak = int(got.peak)
    return {
        "arch": c.name, "shape": shape.name, "mesh": mesh_name,
        "n_devices": N_DEV, "kind": shape.kind, "microbatches": k,
        "optimizer": _pick_opt(c).name if shape.kind == "train" else None,
        "plan": {"tp_heads": False, "fsdp": False, "ep": False,
                 "attn_impl": IMPL[shape.kind], "seq_axis": None},
        "metrics_s": round(time.time() - t0, 2),
        "metrics_pass": metrics,
        "bytes_per_device": peak,
        "fits_hbm_80g": peak < HBM_BYTES,
        "cost_analysis": {"flops": got.flops, "bytes_accessed": got.bytes},
        "bytes_accessed_bound": "unfused: every op's inputs and outputs",
        "collectives": colls.to_dict(),
        "roofline": r.to_dict(),
    }


# ---------------------------------------------------------------------------
# Rank 0 of a mesh: the sharded program on a counting mesh
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Meshes of cards: rank 0's program, its collectives counted
# ---------------------------------------------------------------------------


#: cards a node: ranks ``8 n .. 8 n + 7`` share one node's NVLink
NODE_CARDS = 8


class CountingMesh(MeshShape):
    """Rank ``rank``'s view of a mesh that runs no collective: each
    collective returns a tensor of the right shape (``meta`` in, ``meta``
    out) and records, into :attr:`stats`, its kind, group size, result
    and ring wire bytes (``roofline.hlo.ring_wire_bytes``) and the link
    its group takes (:meth:`link`): the dry run's mesh."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 rank: int = 0):
        super().__init__(shape, axes, rank)
        self.backend = "counting"
        self.stats = CollectiveStats()

    def link(self, axes) -> str:
        """``nvlink`` when this rank's group over ``axes`` sits in one
        node (ranks map row-major, :data:`NODE_CARDS` a node), else
        ``network`` (``roofline.analysis.LINK_BWS`` prices both)."""
        nodes = {r // NODE_CARDS for r in self.group_ranks(axes)}
        return "nvlink" if len(nodes) == 1 else "network"

    def _record(self, op: str, axes, result: torch.Tensor) -> None:
        g = self.axes_size(axes)
        if g == 1:
            return
        b = result.numel() * result.element_size()
        self.stats.add(op, b, ring_wire_bytes(op, b, g), g,
                       self.link(axes), "+".join(self._axes(axes)))

    def all_reduce(self, t, axes, op: str = "sum"):
        self._record("all-reduce", axes, t)
        return t if self.axes_size(axes) == 1 else t.clone()

    def all_gather(self, t, axes, dim: int = 0):
        n = self.axes_size(axes)
        if n == 1:
            return t
        out = torch.cat([t] * n, dim=dim)
        self._record("all-gather", axes, out)
        return out

    def reduce_scatter(self, t, axes, dim: int = 0):
        n = self.axes_size(axes)
        if n == 1:
            return t
        out = t.narrow(dim, 0, t.shape[dim] // n).clone()
        self._record("reduce-scatter", axes, out)
        return out

    def all_to_all(self, t, axes, split_dim: int, concat_dim: int):
        n = self.axes_size(axes)
        if n == 1:
            return t
        part = t.narrow(split_dim, 0, t.shape[split_dim] // n)
        out = torch.cat([part] * n, dim=concat_dim)
        self._record("all-to-all", axes, out)
        return out

    def all_gather_object(self, obj, axes) -> list:
        return [obj] * self.axes_size(axes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """Single pod: (16, 16) ("data", "model") = 256 cards. Multi-pod:
    (2, 16, 16) ("pod", "data", "model") = 512 cards; the "pod" axis is
    data-parallel. A description without process groups (the dry run
    counts rank 0's program on it through a :class:`CountingMesh`)."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def mesh_microbatching(c: ModelConfig, plan, shape: ShapeConfig,
                       microbatch_size: int = 4) -> int:
    """The reference's microbatch count on a mesh: ``microbatch_size``
    rows a dp rank, 1 with FSDP or above 16 B params, at most 2 above
    4 B."""
    if shape.kind != "train":
        return 1
    params_b = c.param_count()
    if params_b > 16e9 or plan.fsdp:
        microbatch_size = 1
    elif params_b > 4e9:
        microbatch_size = min(microbatch_size, 2)
    per_dev = max(shape.global_batch // max(shd.dp_size(plan), 1), 1)
    return max(per_dev // microbatch_size, 1)


def sharded_counts(c: ModelConfig, shape: ShapeConfig, mesh: MeshShape, *,
                   microbatch_size: int = 4,
                   step_overrides: Optional[dict] = None,
                   plan_overrides: Optional[dict] = None,
                   metrics: bool = True) -> tuple:
    """``(Counts, k, CollectiveStats, plan, optimizer)`` of rank 0's
    program of the cell on ``mesh`` (a shape: no process group),
    traced on ``meta`` under a ``CountingMesh``. A train step of ``k >
    2`` microbatches is extrapolated from traces of one and two
    (``metrics``) or scaled from one of two (``metrics=False``, the
    memory pass)."""
    cm = CountingMesh(tuple(mesh.shape.values()), mesh.axis_names)
    plan = shd.make_plan(c, cm, shape)
    if plan_overrides:
        plan = dataclasses.replace(plan, **plan_overrides)
    whole = lm.init_abstract(c)
    zero = shd.Zero1(plan, whole, c)
    params = zero.shard(whole)
    k = mesh_microbatching(c, plan, shape, microbatch_size)
    oc = _pick_opt(c, cm.size) if shape.kind == "train" else None
    if shape.kind == "train":
        opt = shd.shard_opt_state(zero, opt_init(oc, whole))

        def trace(kt: int):
            cm.stats = CollectiveStats()
            sc = StepConfig(microbatches=kt, remat="full",
                            impl=plan.attn_impl, **(step_overrides or {}))
            # the global rows of kt microbatches (on meta: no memory), so
            # the step cuts this rank's rows as it does on the ranks
            batch = specs_mod.train_batch_specs(
                c, dataclasses.replace(shape, global_batch=kt * (
                    shape.global_batch // k)))
            step = make_train_step(c, oc, sc, plan=plan, zero=zero)
            with _program_ctx(c, plan):
                got = count(lambda: step(params, opt, batch),
                            (params, opt, batch))
            return got, cm.stats, batch

        if k > 2 and metrics:
            (g1, s1, _), (g2, s2, part) = trace(1), trace(2)
            got = g1 + (g2 - g1) * (k - 1)
            got.peak = g2.peak
            stats = _combine([(s1, 2 - k), (s2, k - 1)])
        else:
            kt = min(k, 2)
            got, stats, part = trace(kt)
            got = Counts(got.flops * k / kt, got.bytes * k / kt, got.peak)
            stats = _combine([(stats, k / kt)])
        # the peak holds this rank's rows of the step, not the global
        # rows the trace cut them from
        full = specs_mod.train_batch_specs(c, shape, plan, k)
        got.peak += _nbytes(full) - _nbytes(part)
        return got, k, stats, plan, oc
    axes = batch_axes(plan, shape.global_batch)
    seq = plan.seq_axis if shape.kind == "decode" and not axes else None
    lay = zero.layout(axes, seq)
    with torch.no_grad(), _program_ctx(c, plan), layout_mod.use(lay):
        if shape.kind == "prefill":
            tokens, extras = specs_mod.prefill_specs(c, shape, plan)
            fn = make_prefill_fn(c, plan.attn_impl)
            got = count(lambda: fn(params, tokens, extras),
                        (params, tokens, extras))
        else:
            token, caches, _pos, enc_kv = specs_mod.decode_specs(
                c, shape, params, plan, lay)
            cm.stats = CollectiveStats()       # the encoder is set-up
            fn = make_decode_fn(c, IMPL["decode"])
            got = count(lambda: fn(params, token, caches,
                                   shape.seq_len - 1, enc_kv),
                        (params, token, caches, enc_kv))
    return got, k, cm.stats, plan, oc


def _combine(weighted) -> CollectiveStats:
    """Sum of ``CollectiveStats`` with weights (the reference's
    ``_combine_colls``, groups included)."""
    out = CollectiveStats()
    for st, w in weighted:
        for op, n in st.counts.items():
            out.counts[op] += n * w
        for op, b in st.result_bytes.items():
            out.result_bytes[op] += b * w
        for op, b in st.wire_bytes.items():
            out.wire_bytes[op] += b * w
        for axes, g in st.groups.items():
            grp = out.groups.setdefault(axes, {
                "size": g["size"], "link": g["link"],
                "counts": collections.defaultdict(float),
                "wire_bytes": 0.0})
            for op, n in g["counts"].items():
                grp["counts"][op] += n * w
            grp["wire_bytes"] += g["wire_bytes"] * w
    return out


def sharded_record(c: ModelConfig, shape: ShapeConfig, mesh_name: str,
                   mesh: MeshShape, **kw) -> dict:
    """One cell's record on rank 0 of ``mesh`` (the reference's schema:
    per-rank FLOPs, bytes, peak and ``fits_hbm_80g``, the collectives
    with their groups and links, the roofline with each group's link
    bandwidth)."""
    t0 = time.time()
    got, k, stats, plan, oc = sharded_counts(c, shape, mesh, **kw)
    r = roof.analyze(c, shape, mesh_name=mesh_name, n_devices=mesh.size,
                     flops_per_device=got.flops,
                     hbm_bytes_per_device=got.bytes,
                     wire_bytes_per_device=stats.total_wire_bytes,
                     wire_bytes_by_link=stats.wire_bytes_by_link())
    peak = int(got.peak)
    rows = shape.global_batch // k
    hints = shd.attn_hints(c, plan, rows, cache_seq=shape.seq_len
                           if shape.kind == "decode" else 0,
                           decode=shape.kind == "decode",
                           seq_len=shape.seq_len)
    return {
        "arch": c.name, "shape": shape.name, "mesh": mesh_name,
        "n_devices": mesh.size, "kind": shape.kind, "microbatches": k,
        "optimizer": oc.name if oc is not None else None,
        "plan": {"tp_heads": plan.tp_heads, "fsdp": plan.fsdp,
                 "ep": plan.ep, "attn_impl": plan.attn_impl,
                 "seq_axis": plan.seq_axis, "use_tp": plan.use_tp},
        # the reference's sharding hints of the cell, as specs
        "attn_hints": dataclasses.asdict(hints),
        "metrics_s": round(time.time() - t0, 2),
        "metrics_pass": kw.get("metrics", True),
        "bytes_per_device": peak,
        "fits_hbm_80g": peak < HBM_BYTES,
        "cost_analysis": {"flops": got.flops, "bytes_accessed": got.bytes},
        "bytes_accessed_bound": "unfused: every op's inputs and outputs",
        "collectives": stats.to_dict(),
        "links": {a: g["link"] for a, g in stats.groups.items()},
        "roofline": r.to_dict(),
    }


def _cell_record(mesh_name: str, arch: str, sname: str,
                 microbatch_size: int, metrics: bool = True) -> dict:
    """One cell's record, or its error record (failures are bugs to fix,
    recorded, as the reference records them)."""
    try:
        return lower_cell(get_config(arch), SHAPES[sname], mesh_name,
                          microbatch_size=microbatch_size, metrics=metrics)
    except Exception as e:  # noqa: BLE001 - a cell's failure is its record
        return {"arch": arch, "shape": sname, "mesh": mesh_name,
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def _trace_cost(c: ModelConfig, sname: str) -> float:
    """A rough rank of a cell's trace time: its layers, times its kind's
    ops a layer."""
    return (c.n_layers + c.n_enc_layers) * {
        "train": 3.0, "prefill": 2.0}.get(SHAPES[sname].kind, 0.1)


def run_cells(archs, shapes, meshes, out_dir: pathlib.Path,
              microbatch_size: int = 4, tag: str = "",
              workers: int = 1, metrics_pass: bool = True) -> list[dict]:
    """Count every cell, ``workers`` cells at a time (spawned processes;
    a cell is independent of the others), and write one record each
    (``metrics_pass=False``: the memory pass, ``lower_cell``)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    todo, results = [], []
    for mesh_name in meshes:
        if mesh_name != MESH and mesh_name not in PRODUCTION:
            raise ValueError(f"mesh {mesh_name!r}: one of "
                             f"{[MESH, *PRODUCTION]}")
        for arch in archs:
            c = get_config(arch)
            for sname in shapes:
                if sname == "long_500k" and not c.long_context_ok:
                    results.append({
                        "arch": arch, "shape": sname, "mesh": mesh_name,
                        "skipped": "full quadratic attention (DESIGN.md)"})
                    continue
                todo.append((mesh_name, arch, sname))
    with contextlib.ExitStack() as st:
        # the costliest traces first (deep train steps, then the 32k
        # prefills), so that no long cell starts last
        order = sorted(range(len(todo)), key=lambda i: -_trace_cost(
            get_config(todo[i][1]), todo[i][2]))
        if workers > 1:
            pool = st.enter_context(ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")))
            futs = {i: pool.submit(_cell_record, *todo[i], microbatch_size,
                                   metrics_pass)
                    for i in order}
            recs = (futs[i].result() for i in range(len(todo)))
        else:
            recs = (_cell_record(*cell, microbatch_size, metrics_pass)
                    for cell in todo)
        for (mesh_name, arch, sname), rec in zip(todo, recs):
            fn = out_dir / f"{mesh_name}__{arch}__{sname}{tag}.json"
            line = f"[dryrun] {mesh_name:6s} {arch:28s} {sname:12s} ... "
            if "error" in rec:
                print(line + f"FAIL {rec['error'][:120]}", flush=True)
            else:
                rf = rec["roofline"]
                print(line + f"ok metrics={rec['metrics_s']:.1f}s "
                      f"bottleneck={rf['bottleneck']:10s} "
                      f"frac={rf['roofline_fraction']:.3f} "
                      f"fits={rec['fits_hbm_80g']}", flush=True)
            fn.write_text(json.dumps(rec, indent=1))
            results.append(rec)
    return results


# ---------------------------------------------------------------------------
# A real step of a cell, against its counts
# ---------------------------------------------------------------------------


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def real_step(c: ModelConfig, shape: ShapeConfig,
              device: DeviceLike = None) -> dict:
    """Run the cell's step twice on ``device`` (default the card) with
    random params from seed 0: its matmul FLOPs under
    ``FlopCounterMode`` (the first step), the second step's wall time
    and, on the card, its peak allocated bytes above
    what was allocated before its inputs, less what the first step left
    allocated beyond its inputs (``workspace_bytes``: the libraries'
    workspaces, cuBLAS's, which no trace of the program sees), beside
    the meta counts of the same cell at full depth. The caches are
    zeros (counts and times do not depend on values)."""
    dev = resolve_device(device)
    want, k = cell_counts(c, shape)
    if k != 1:
        raise ValueError(f"{c.name} {shape.name}: a real step runs one "
                         f"microbatch; this shape needs {k}")
    gen = torch.Generator(device=dev).manual_seed(0)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
    params = lm.init(c, gen, dev)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        oc = _pick_opt(c)
        state = opt_init(oc, params)
        batch = {name: _like(t, gen, c, dev) for name, t in
                 specs_mod.train_batch_specs(c, shape).items()}
        fn = make_train_step(c, oc, StepConfig(remat="full",
                                               impl=IMPL["train"]))
        run = lambda: fn(params, state, batch)              # noqa: E731
        grad = True
    elif shape.kind == "prefill":
        tokens, extras = specs_mod.prefill_specs(c, shape)
        tokens = _like(tokens, gen, c, dev)
        extras = {n: _like(t, gen, c, dev) for n, t in extras.items()}
        fn = make_prefill_fn(c, IMPL["prefill"])
        run = lambda: fn(params, tokens, extras)            # noqa: E731
        grad = False
    else:
        caches = slotted_cache(c, b, s, device=dev)
        token = torch.randint(0, c.vocab, (b, 1), generator=gen, device=dev,
                              dtype=torch.int32)
        enc_kv = None
        if c.family == "encdec":
            frames = torch.randn((b, c.enc_seq, c.d_model), generator=gen,
                                 device=dev).to(dtype_of(c))
            with torch.no_grad():
                enc_kv = lm.encode(c, params, frames)[1]
        fn = make_decode_fn(c, IMPL["decode"])
        run = lambda: fn(params, token, caches, s - 1, enc_kv)  # noqa: E731
        grad = False

    def step():
        with torch.set_grad_enabled(grad), _program_ctx(c):
            return run()

    if cuda:
        inputs = torch.cuda.memory_allocated(dev) - base
    with FlopCounterMode(display=False) as fc:
        step()
        _sync(dev)
    workspace = None
    if cuda:
        workspace = torch.cuda.memory_allocated(dev) - base - inputs
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    step()
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    measured = (torch.cuda.max_memory_allocated(dev) - base - workspace
                if cuda else None)
    r = roof.analyze(c, shape, mesh_name=MESH, n_devices=N_DEV,
                     flops_per_device=want.flops,
                     hbm_bytes_per_device=want.bytes,
                     wire_bytes_per_device=0.0)
    return {"arch": c.name, "shape": shape.name,
            "global_batch": shape.global_batch, "device": str(dev),
            "flops_meta": want.flops, "flops_device": float(
                fc.get_total_flops()),
            "peak_bytes_estimate": int(want.peak),
            "peak_bytes_measured": measured, "workspace_bytes": workspace,
            "step_ms": ms, "bound_ms": r.step_time_s * 1e3,
            "bottleneck": r.bottleneck,
            "roofline_share": r.step_time_s * 1e3 / ms}


def _like(t: torch.Tensor, gen, c: ModelConfig, dev) -> torch.Tensor:
    """A random tensor of a meta spec's shape and dtype on ``dev``."""
    if t.dtype in (torch.int32, torch.int64):
        return torch.randint(0, c.vocab, t.shape, generator=gen, device=dev,
                             dtype=t.dtype)
    return torch.randn(t.shape, generator=gen, device=dev).to(t.dtype)


def _parse_real(spec: str) -> ShapeConfig:
    arch, sname, *batch = spec.split(":")
    shape = SHAPES[sname]
    if batch:
        shape = dataclasses.replace(shape, global_batch=int(batch[0]))
    return get_config(arch), shape


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--paper-models", action="store_true")
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--mesh", choices=["1xh100", "single", "multi", "both"],
                    default="1xh100")
    ap.add_argument("--out", default=str(ART))
    ap.add_argument("--tag", default="")
    ap.add_argument("--no-metrics", action="store_true",
                    help="the memory pass only (the multi mesh always "
                         "takes it): a train step's bytes scaled from its "
                         "trace of at most two microbatches")
    ap.add_argument("--workers", type=int, default=1,
                    help="cells counted at once, each in its own process")
    ap.add_argument("--real", action="append", default=None,
                    metavar="ARCH:SHAPE[:BATCH]",
                    help="run the cell's step on --device against its "
                         "meta counts")
    ap.add_argument("--device", default=None,
                    help="the device of --real (default: the card)")
    args = ap.parse_args(argv)

    if args.real:
        for spec in args.real:
            c, shape = _parse_real(spec)
            print(json.dumps(real_step(c, shape, args.device)))
        return 0
    archs = args.arch or list(ASSIGNED)
    if args.paper_models:
        archs += list(PAPER_MODELS)
    shapes = args.shape or list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    t0 = time.time()
    results = run_cells(archs, shapes, meshes, pathlib.Path(args.out),
                        tag=args.tag, workers=args.workers,
                        metrics_pass=not args.no_metrics)
    n_ok = sum(1 for r in results if "roofline" in r)
    n_skip = sum(1 for r in results if "skipped" in r)
    n_fail = sum(1 for r in results if "error" in r)
    print(f"\n[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_fail} FAILED "
          f"in {time.time() - t0:.1f} s")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
