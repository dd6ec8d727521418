#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py [--profile | --times | --train [--profile]]

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
sm_90a) and checks that the bf16 tensor-core kernels (flash attention
and paged prefill on ``csrc/attention_mma.cuh``) issue
``HMMA.16816.F32.BF16`` in the library's SASS and that they, the paged
decode kernel and both RMSNorm kernels spill no register in any
instance, then runs eight phases, any failure of which exits non-zero:

  1. kernels — each hand-written kernel against its plain PyTorch
     version on the card: paged decode and paged prefill (each on fp and
     int8 pools) at full llama3.2-3b head shapes (H=24, Kh=8, Dh=128,
     bs=16, B=8) and the serve run's table widths, prefix depths and
     suffix buckets, the decode also at B=1 (one sequence over many
     splits), B=32 and with a window that hides whole splits; flash
     attention over the reference's SWEEP and a
     2048-token llama3.2-3b prefill; RMSNorm over the reference's sweep
     and (4096, 3072): |kernel - plain| <= tol * (1 + |plain|). The
     plain version always runs in fp32 on the inputs upcast, its result
     cast to the kernel's type, so tol is 1e-3 in fp32 (summation order)
     and 2**-7 in bf16 (one bf16 ulp of the output: the kernel computes
     in fp32 and rounds once). In bf16 at most 1 % of the outputs may
     differ at all: a rounding flip needs the two fp32 results to
     straddle a bf16 rounding point, which summation order alone rarely
     does, while a wrong conversion moves about half of them;
  2. serve — full-width, full-depth llama3.2-3b (bf16, seeded random
     weights) through ``ServeEngine(cache="paged", sched="phased",
     prefix_cache=True)`` with NVML's energy counter: 16 requests, half
     behind a shared 256-token system prompt; every request must finish,
     both
     kernels must have launched (decode once per layer and step), and
     the pool must drain clean (``--profile`` serves the set once more
     under ``torch.profiler`` and prints the device-busy share and the
     device time by kernel, here and for phase 2b's int8 run; several
     minutes more);
  2b. int8 chunked serve — the same model and requests, all arriving at
     once (so the schedule, and with it the preemption count, does not
     depend on the card's speed), through ``ServeEngine(cache="paged",
     sched="chunked", kv_dtype="int8", prefix_cache=True,
     chunk_tokens=32)`` on an oversubscribed pool of ``INT8_POOL_BLOCKS``
     blocks (two full slots plus the trash block), with NVML's energy
     counter:
     every request must finish its budget, the scheduler must preempt at
     least once and replay at least one token,
     every decode micro-step must launch the decode kernel's int8 path
     once per layer, every prefill over pool blocks (chunks after the
     first, prefix hits) the prefill kernel's int8 path once per layer,
     and the pool must drain clean; then the same on a bf16 pool of as
     many blocks, which must take the same schedule (its TPOT beside the
     int8 run's is the int8 path's cost);
  3. agreement — a reduced fp32 llama3.2-3b served on the card (kernels)
     and on the CPU (plain versions) from the same weights must give the
     same greedy streams (LCP agreement >= 0.95), and so must the card
     against the CPU on int8 pools (chunked), and the card's chunked
     scheduler on a pool that makes it preempt against its phased one;
  4. bench — the port's ``kernels`` benchmark entry point,
     ``python -m repro_torch.bench run --suite kernels`` (in process, no
     power), on its full Space: the reference's five cases and four at
     llama3.2-3b width, each kernel beside its plain version; every
     record must be ``ok``, every ``cuda`` row within the gate above, the
     results must read back, and flash attention, RMSNorm and the int8
     prefill path must have launched;
  5. times — each kernel at main-path shapes beside its plain version,
     the one PyTorch call that computes the same function
     (``scaled_dot_product_attention``, ``rms_norm``; never used by the
     port), the least time the card could take and the kernel's TFLOP/s
     (its operations over its time). ``ms`` is 50 back-to-back calls
     between two events (host enqueue included, inputs warm in L2);
     ``device_ms`` replays a CUDA graph of 20 captured calls between two
     events, so the host drops out, and ``device_ms_cold`` the same over
     calls that cycle through copies of the inputs reading more than
     twice the card's 50 MB L2, so each call finds its inputs in device
     memory, as the serve path's 28 layers of pools do; the library call
     gets both too (``library_device_ms``, ``library_device_ms_cold``).
     SDPA reads K/V gathered to the whole 64-column table; the decode
     rows also time it on K/V cut to the longest sequence's blocks
     (``library_cut_device_ms``, ``library_cut_device_ms_cold``), the
     least a dense call over this batch must read.
     The decode and RMSNorm rows add the wrapper's host time per call
     (``host_us``: the host clock around 1000 calls, no synchronise, on
     inputs that take the same wrapper path with a short kernel: every
     decode length 1, 8 RMSNorm rows; the least of three rounds).
     The fp decode and prefill rows count their launches in phase 2, the
     int8 decode row in phase 2b, the others in phase 4;
  6. serve workloads — the port's ``serve`` and ``serve_slo`` workloads,
     ``python -m repro_torch.bench run --suite serve`` (then
     ``serve_slo``, twice) ``--smoke --power auto`` in process, at full
     llama3.2-3b width on NVML's energy counter, narrowed by
     ``SERVE_POINTS`` and ``SLO_POINTS`` to the main-path cell
     (``cache=paged, policy=continuous, sched=phased, kv_dtype=fp32``)
     with its slotted, fixed (measured on demand), int8 and chunked
     twins, and the ``long_prefill`` (both schedulers) and
     ``shared_prefix`` traces: every record must be ``ok`` and labelled
     ``nvml_energy``; every paged cell must launch the decode kernel once
     per layer and micro-step, on the int8 path exactly when its pool is
     int8, and the prefill kernel once per layer and prefill over pool
     blocks; slotted cells launch no paged kernel (the reference's
     design); ``long_prefill`` under ``chunked`` must preempt, launch the
     prefill kernel, emit its phased twin's token count and agree with
     its streams as phase 3's do (its chunks after the first take the
     prefill kernel's fp32 scores where phased takes bf16 ``sdpa``, so
     a near-tie may flip and the hashes differ; they are equal on the
     CPU), while the serve workload's fp chunked cell, whose arithmetic
     is its phased twin's, must give equal streams;
     ``shared_prefix`` under ``paged+prefix`` must hit the prefix index
     and launch the prefill kernel. One line per record gives its cell
     and headline columns (``--profile`` also traces the main-path cell
     and prints its device-busy share: ~11 min more).
  7. train — the training path at full width, in process, on NVML's
     energy counter: (a) the ``llm_train`` workload, ``python -m
     repro_torch.bench run --suite llm_train --points placement=dp1
     --power auto --iters TRAIN_ITERS``, its whole Space at dp1 (global
     batch 16, 32, 64 x grad_sync fp32, int8) on full-width gpt-800m
     (bf16, fp32 master weights, 4 microbatches, full remat): every
     record ``ok``, ``nvml_energy``, ``model_scale=full``, with falling
     loss and finite tokens/Wh; one line per cell with tok/s, ms/step,
     Wh/step, tokens/Wh, peak GB and the model-FLOP share (8 N tokens,
     full remat, over the step time against the card's dense bf16 peak);
     (b) a reduced fp32 gpt-800m trains three AdamW steps (4
     microbatches) on the card and on the CPU from the same weights:
     losses agree at rtol 1e-4, and the params' largest difference is
     printed; (c) the ``resilience`` smoke preset at full gpt-117m
     width: every record ``ok``, ``loss_bitmatch == 1.0`` (the resumed
     loss trace equals the uninterrupted twin's, element for element),
     ``crash_mid`` restarts at least once. ``--profile`` also traces one
     gpt-800m step at global batch 64 under ``torch.profiler``: the
     device-busy share and the device time split into GEMMs, optimizer,
     elementwise (and reductions) and copies, beside the optimizer's
     bound from its bytes (~2 min more).

``--train`` runs phase 7 alone (no kernel is built: the training path
launches none) and prints no result line.
``--times`` builds and runs phase 5 alone and prints its rows as a
``{"times": [...]}`` line, without ``launches`` and ``max_abs_err``
(neither is measured there), and no result line: for timing another
tree's kernels with this script's method, by copying the script into
that tree's root.

The output ends with the script's wall time and three lines: a JSON
object with one entry per kernel, the card's name and power limit as
``nvidia-smi`` gives them, and ``{"ok": true, "device": {...}}``.
Without a card, or without the repository around it, the script fails
and prints no result.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-3}
MAX_BF16_MISMATCH_SHARE = 1e-2
#: least LCP agreement of two greedy stream sets whose arithmetic differs
#: only in summation order or rounding (a near-tie may flip)
STREAM_AGREEMENT = 0.95
H, KH, DH, BS, B = 24, 8, 128, 16, 8
#: the reference's flash SWEEP (tests/test_kernels.py:11-21), a ragged
#: case and a 2048-token llama3.2-3b prefill: b, sq, skv, h, kh, dh,
#: causal, window
FLASH_SWEEP = [
    (1, 128, 128, 1, 1, 64, True, None),
    (2, 256, 256, 4, 2, 64, True, None),
    (1, 256, 256, 8, 8, 128, True, None),
    (2, 128, 256, 4, 4, 64, True, None),
    (1, 256, 256, 6, 2, 64, True, 128),
    (1, 512, 512, 2, 1, 128, True, 256),
    (2, 256, 256, 4, 2, 64, False, None),
    (1, 384, 384, 3, 3, 64, True, None),
    (1, 200, 333, 6, 2, 128, True, 100),      # ragged tiles, G = 3
    (2, 2048, 2048, H, KH, DH, True, None),
]
#: the reference's rmsnorm sweep (tests/test_kernels.py:79-82) plus 4096
#: tokens at llama3.2-3b width
RMSNORM_SWEEP = [(8, 64), (37, 512), (300, 128), (1, 1024), (4096, 3072)]
INT8 = "paged_prefill_attention[int8]"
#: the tensor-core kernels (csrc/attention_mma.cuh) and the SASS
#: instruction each must issue
MMA_KERNELS = ("flash_mma_kernel", "paged_prefill_mma_kernel")
HMMA = "HMMA.16816.F32.BF16"
#: kernels whose every instance must spill nothing, besides MMA_KERNELS
#: (names as mangled: length, then the name)
NO_SPILL_KERNELS = ("paged_decode_kernel", "rmsnorm_vec_kernel",
                    "rmsnorm_kernel")
#: the port's kernels in a profiler table
PORT_KERNELS = ("paged_decode_kernel", "paged_prefill", "flash_",
                "rmsnorm")
#: bytes the cold timing's input copies read per cycle: twice the L2
COLD_BYTES = 100e6
DECODE_INT8 = "paged_decode_attention[int8]"
#: the int8 chunked serve's pool: two full slots of 64 blocks plus the
#: trash block, for 8 slots (28 layers x 129 blocks x 16 x 8 x 128 x 2 B
#: of codes = 118 MB); with the serve requests arriving at once the
#: scheduler preempts there (the count depends on the pool's size, not
#: monotonically: run the phase on the CPU with a reduced model to
#: check another size)
INT8_POOL_BLOCKS = 129
#: phase 6's ``--points``: the serve workload's main-path cell with its
#: slotted and int8 twins (chunked and int8 x chunked follow from the
#: kv_dtype and sched axes, the fixed twin is measured on demand inside
#: each continuous cell); serve_slo's long_prefill trace on the plain
#: fp pool under both schedulers, and its shared_prefix trace phased,
#: with and without the prefix cache (two runs of the CLI)
SERVE_POINTS = "cache=slotted,cache=paged,policy=continuous"
SLO_POINTS = ("trace=long_prefill,cache=paged,kv_dtype=fp32",
              "trace=shared_prefix,kv_dtype=fp32,sched=phased")
#: phase 7's measured steps per llm_train cell: two windows of two
#: ~0.9 s steps, many times the NVML energy counter's ~100 ms update
#: interval
TRAIN_ITERS = 4
#: AdamW's least HBM traffic per parameter: read the fp32 grad, m, v and
#: master, write m, v and master (fp32) and the bf16 param
ADAMW_BYTES_PER_PARAM = 4 * 4 + 3 * 4 + 2
#: phase 7's profiler ranges (train/step.py, grad_sync.py, optimizer.py)
TRAIN_RANGES = ("forward_backward", "grad_sync", "optimizer")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of ``fn()`` over ``iters`` back-to-back calls between two
    events: the host's enqueue cost is in it where it exceeds the
    kernel's."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fns, calls: int, replays: int = 10) -> float:
    """Device time per call: ``calls`` calls, cycling through ``fns``,
    captured in one CUDA graph and replayed ``replays`` times between two
    events, so no host work lies between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):         # warm up off the capture
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):   # the warmed-up stream
        for i in range(calls):
            fns[i % len(fns)]()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def device_times(fn, args, kw, read_bytes: int) -> tuple:
    """(warm, cold) device ms per call of ``fn(*args, **kw)``: warm on
    these inputs, cold cycling through copies of them that read more
    than ``COLD_BYTES`` a cycle."""
    clone = lambda x: x.clone() if torch.is_tensor(x) else x
    copies = max(2, math.ceil(COLD_BYTES / read_bytes))
    sets = [(tuple(map(clone, args)), {k: clone(v) for k, v in kw.items()})
            for _ in range(copies)]
    warm = [functools.partial(fn, *args, **kw)]
    cold = [functools.partial(fn, *a, **k) for a, k in sets]
    return graph_ms(warm, 20), graph_ms(cold, 2 * copies)


def host_us(fn, calls: int = 1000, rounds: int = 3) -> float:
    """The host's time per call: the clock around ``calls`` calls, no
    synchronise in between (what the serve step pays per call); the
    least of ``rounds`` rounds, since the host's cores are shared. Give
    ``fn`` inputs whose kernel is short, or a full launch queue makes
    this read the card."""
    best = math.inf
    for _ in range(rounds):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / calls * 1e6


def tensor_bytes(args, kw) -> int:
    return sum(t.numel() * t.element_size()
               for t in (*args, *kw.values()) if torch.is_tensor(t))


def check_build(build) -> None:
    """The tensor-core kernels must issue ``HMMA`` (``mma.sync`` bf16 with
    fp32 accumulation) in the built library's SASS (``cuobjdump``, beside
    ``nvcc``) and spill no register (``ptxas -v`` in the build log); logs
    both, and the registers, per kernel instance. Every instance of the
    ``NO_SPILL_KERNELS`` must spill nothing either."""
    ptxas, name = {}, None
    for line in build.build_log().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name is not None and "spill stores" in line:
            ptxas[name] = [int(re.search(r"(\d+) bytes spill stores",
                                         line).group(1)), None]
        elif name in ptxas and "Used" in line and "registers" in line:
            ptxas[name][1] = int(re.search(r"Used (\d+) registers",
                                           line).group(1))
    tool = Path(build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "--dump-sass", str(build.build())],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            counts[name] = 0
        elif name is not None and HMMA in line:
            counts[name] += 1
    for kernel in MMA_KERNELS:
        found = {n: c for n, c in counts.items() if kernel in n}
        assert found and all(found.values()), (kernel, found)
        for n, c in sorted(found.items()):
            # mangled template arguments: ILi<Dh>E, then a (int8) or a
            # bf16 pool type for the prefill kernel
            args = n[n.index(kernel) + len(kernel):]
            dh = re.match(r"ILi(\d+)E", args).group(1)
            pool = "" if kernel.startswith("flash") else (
                ", int8 pool" if args.startswith(f"ILi{dh}EaE")
                else ", bf16 pool")
            spilled, regs = ptxas.get(n, (None, None))
            log(f"[build] {kernel}<Dh {dh}{pool}>: {c} x {HMMA} in SASS, "
                f"{regs} registers, {spilled} bytes spilled")
            assert spilled == 0, (n, spilled)
    for kernel in NO_SPILL_KERNELS:
        found = {n: v for n, v in ptxas.items()
                 if f"{len(kernel)}{kernel}I" in n}
        assert found, (kernel, sorted(ptxas))
        regs = sorted({r for _, r in found.values()})
        spilled = {n: v[0] for n, v in found.items() if v[0]}
        log(f"[build] {kernel}: {len(found)} instances, {regs[0]}-"
            f"{regs[-1]} registers, spills {spilled or 0}")
        assert not spilled, (kernel, spilled)


# ---------------------------------------------------------------------------
# inputs at main-path shapes
# ---------------------------------------------------------------------------


def decode_case(rng, lengths, dtype, dev, nb=64, width=64, int8=False):
    """Decode inputs whose tables are the first ``nb`` columns of a
    ``(B, width)`` table, as the engine slices its device tables to the
    power-of-two bucket of the longest live slot. With ``int8`` the pools
    are int8 codes and the returned kwargs carry their (n_blocks, Kh)
    scales."""
    from repro_torch.bench.workloads.kernels import quantize
    b = len(lengths)
    n_blocks = 1 + b * nb
    perm = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((b, width), np.int32)         # unowned -> trash 0
    for i, ln in enumerate(lengths):
        need = -(-int(ln) // BS)
        tables[i, :need] = perm[i * nb:i * nb + need]
    t = lambda *s: torch.randn(*s, device=dev, dtype=torch.float32).to(dtype)
    kp, vp = t(n_blocks, BS, KH, DH), t(n_blocks, BS, KH, DH)
    kw = {}
    if int8:
        kp, kw["k_scale"] = quantize(kp.float())
        vp, kw["v_scale"] = quantize(vp.float())
    return (t(b, H, DH), kp, vp, torch.from_numpy(tables).to(dev)[:, :nb],
            torch.from_numpy(np.asarray(lengths, np.int32)).to(dev)), kw


def prefill_case(rng, npre, sq, dtype, dev, int8=False):
    """Prefix-hit prefill inputs; the last row is a batch pad row whose
    table names only the trash block 0, as the engine pads its groups.
    With ``int8`` the pools are int8 codes and the kwargs carry their
    (n_blocks, Kh) scales, quantized as the ``kernels`` workload does."""
    from repro_torch.bench.workloads.kernels import quantize
    n_blocks = 1 + B * npre + 4
    tables = rng.permutation(np.arange(1, n_blocks))[:B * npre]
    tables = tables.reshape(B, npre).astype(np.int32)
    tables[-1] = 0
    t = lambda *s: torch.randn(*s, device=dev, dtype=torch.float32).to(dtype)
    kp, vp = t(n_blocks, BS, KH, DH), t(n_blocks, BS, KH, DH)
    kw = {}
    if int8:
        kp, kw["k_scale"] = quantize(kp.float())
        vp, kw["v_scale"] = quantize(vp.float())
    return (t(B, sq, H, DH), t(B, sq, KH, DH), t(B, sq, KH, DH), kp, vp,
            torch.from_numpy(tables).to(dev)), kw


def check_close(got: torch.Tensor, want: torch.Tensor, dtype):
    """Fail unless |got - want| <= tol * (1 + |want|) everywhere (the
    reference's kernel gate, rtol = atol) and, in bf16, unless at most
    ``MAX_BF16_MISMATCH_SHARE`` of the elements differ. Returns the max
    abs error, the largest |got - want| / (1 + |want|) (the number held
    to tol) and the share of elements that differ. ``want`` is the plain
    version run by ``kernels.plain_fp32`` (the ``kernels`` workload's):
    in fp32 on the floating-point inputs upcast, cast back once."""
    from repro_torch.bench.workloads.kernels import error_metrics
    m = error_metrics(got, want)
    ratio, share = m["max_err_ratio"], m["mismatch_share"]
    assert ratio <= TOL[dtype], (
        f"max |err| / (1 + |want|) = {ratio:.3e} > tol {TOL[dtype]:.3e}")
    assert dtype != torch.bfloat16 or share <= MAX_BF16_MISMATCH_SHARE, (
        f"{share:.3e} of the bf16 outputs differ")
    return m["max_err"], ratio, share


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def check_kernel(name: str, worst: dict, got, want, dtype, what: str):
    """check_close, logged; keeps the largest bf16 abs error per kernel
    (the serve path's working type)."""
    torch.cuda.synchronize()
    err, ratio, share = check_close(got, want, dtype)
    log(f"[kernels] {name} {str(dtype)[6:]} {what} max_err={err:.3e} "
        f"max_err_ratio={ratio:.3e} (rtol=atol={TOL[dtype]:.3e}) "
        f"mismatch_share={share:.3e}")
    if dtype == torch.bfloat16:
        worst[name] = max(worst[name], err)


def phase_kernels(dev) -> dict:
    """Kernel vs plain version at main-path shapes: decode on fp and int8
    pools over column slices of a 64-wide table (nb 8, 32, 64) and at the
    split kernel's edges (one sequence over many splits, 32 slots, a
    window that hides whole splits), prefill on fp and int8 pools at the
    serve run's prefix depths (1, 4, 16 blocks) and suffix buckets (16,
    128, 256), flash attention over ``FLASH_SWEEP`` and RMSNorm over
    ``RMSNORM_SWEEP``. Returns the largest bf16 error per kernel."""
    from repro_torch.bench.workloads.kernels import plain_fp32
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(0)
    worst = {"paged_decode_attention": 0.0, "paged_prefill_attention": 0.0,
             "flash_attention": 0.0, "rmsnorm": 0.0, INT8: 0.0,
             DECODE_INT8: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for nb in (8, 32, 64):
            for window in (None, 256):
                for name, int8 in (("paged_decode_attention", False),
                                   (DECODE_INT8, True)):
                    lengths = rng.integers(1, nb * BS + 1, size=B)
                    lengths[0], lengths[1] = 1, nb * BS
                    args, kw = decode_case(rng, lengths, dtype, dev, nb=nb,
                                           int8=int8)
                    check_kernel(
                        name, worst,
                        ops.paged_decode_attention(*args, window=window,
                                                   **kw),
                        plain_fp32(ref.paged_decode_attention_ref, *args,
                                   window=window, **kw), dtype,
                        f"nb={nb}/64 window={window} "
                        f"lengths={lengths.tolist()}")
        for lengths, window in (([900], None), ([900], 40),
                                (rng.integers(1, 1025, size=32), None),
                                ([1024, 1000, 513, 512, 65, 64, 17, 1], 40)):
            for name, int8 in (("paged_decode_attention", False),
                               (DECODE_INT8, True)):
                args, kw = decode_case(rng, lengths, dtype, dev, int8=int8)
                check_kernel(
                    name, worst,
                    ops.paged_decode_attention(*args, window=window, **kw),
                    plain_fp32(ref.paged_decode_attention_ref, *args,
                               window=window, **kw), dtype,
                    f"B={len(lengths)} nb=64 window={window} "
                    f"lengths={list(lengths)[:8]}")
        for npre in (1, 4, 16):
            for sq in (16, 128, 256):
                for name, int8 in (("paged_prefill_attention", False),
                                   (INT8, True)):
                    args, kw = prefill_case(rng, npre, sq, dtype, dev, int8)
                    check_kernel(
                        name, worst, ops.paged_prefill_attention(*args, **kw),
                        plain_fp32(ref.paged_prefill_attention_ref, *args,
                                   **kw), dtype, f"npre={npre} sq={sq}")
        for b, sq, skv, h, kh, dh, causal, window in FLASH_SWEEP:
            t = lambda *s: torch.randn(*s, device=dev).to(dtype)
            q, k, v = t(b, sq, h, dh), t(b, skv, kh, dh), t(b, skv, kh, dh)
            kw = dict(causal=causal, window=window)
            check_kernel("flash_attention", worst,
                         ops.flash_attention(q, k, v, **kw),
                         plain_fp32(ref.flash_attention_ref, q, k, v, **kw),
                         dtype, f"b={b} sq={sq} skv={skv} h={h} kh={kh} "
                         f"dh={dh} causal={causal} window={window}")
        for rows, d in RMSNORM_SWEEP:
            x = (torch.randn(rows, d, device=dev) * 3).to(dtype)
            s = torch.randn(d, device=dev).to(dtype)
            check_kernel("rmsnorm", worst, ops.rmsnorm(x, s),
                         plain_fp32(ref.rmsnorm_ref, x, s), dtype,
                         f"rows={rows} d={d}")
    return worst


def serve_requests(vocab: int, n: int = 16, seed: int = 0):
    from repro_torch.serve.requests import Request, exponential_arrivals
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, size=256)
    arrivals = exponential_arrivals(rng, n, 20.0)
    reqs = []
    for rid in range(n):
        if rid % 2 == 0:       # shared system prompt + own question
            prompt = np.concatenate(
                [system, rng.integers(0, vocab, size=int(rng.integers(16, 257)))])
        else:
            prompt = rng.integers(0, vocab, size=int(rng.integers(64, 513)))
        reqs.append(Request(rid=rid, prompt=prompt.astype(np.int32),
                            max_new_tokens=int(rng.integers(32, 65)),
                            arrival_s=float(arrivals[rid])))
    return reqs


def full_model(dev):
    """Full-width, full-depth llama3.2-3b with seeded random bf16
    weights on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    c = get_config("llama3.2-3b")
    t0 = time.perf_counter()
    params = lm.init(c, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve] {c.name}: {c.n_layers} layers, d_model {c.d_model}, "
        f"{n_params / 1e9:.3f}B params ({c.param_dtype}) initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    return c, params


def check_served(c, engine, out, reqs) -> None:
    """Every request finished its full budget with in-vocab tokens, and
    the pool drains clean."""
    assert len(out.results) == len(reqs)
    for r, req in zip(sorted(out.results, key=lambda r: r.rid), reqs):
        assert r.finish_reason == "length", (r.rid, r.finish_reason)
        assert len(r.tokens) == req.max_new_tokens, r.rid
        assert all(0 <= t < c.vocab for t in r.tokens), r.rid
    paged = engine._paged
    assert all(len(o) == 0 for o in paged._owned)
    assert paged.free_blocks + paged.reclaimable_blocks == paged.n_blocks - 1
    engine.reset_prefix_cache()
    assert paged.free_blocks == paged.n_blocks - 1


def mean_watts(out) -> float:
    """Mean board power over a serve run's samples: the counter's
    difference over their span (energy samples), or the samples' mean
    (power samples)."""
    ts, ws = out.sample_ts, out.sample_ws
    if out.sample_kind == "energy":
        return (ws[-1] - ws[0]) / max(ts[-1] - ts[0], 1e-9)
    return float(np.mean(ws))


def log_serve(tag: str, out, wall: float, power) -> None:
    from repro_torch.core.metrics import percentile
    s = out.summary
    ttfts = [r.ttft_s for r in out.results]
    decode = [st for st in out.steps if st.kind == "decode"]
    decode_tokens = sum(st.n_tokens for st in decode)
    step_ms = sum(st.duration_s for st in decode) * 1e3 / sum(
        st.n_steps for st in decode)
    log(f"[{tag}] decode_tok_s={decode_tokens / s.decode_s:.1f} "
        f"(decode windows only) decode_step_ms={step_ms:.2f} "
        f"useful_tok_s={s.decode_tok_s:.1f} "
        f"ttft_p50_ms={percentile(ttfts, 50) * 1e3:.1f} "
        f"ttft_p99_ms={percentile(ttfts, 99) * 1e3:.1f} "
        f"tpot_p50_ms={percentile([r.tpot_s for r in out.results], 50) * 1e3:.2f} "
        f"occupancy={s.mean_occupancy:.3f} wh_per_token={s.wh_per_token:.3e} "
        f"power_source={power.name} mean_w={mean_watts(out):.1f} "
        f"wall_s={wall:.2f}")


def phase_serve(dev, c, params, profile: bool = False) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.power.methods import NvmlEnergy
    from repro_torch.serve.engine import ServeEngine

    power = NvmlEnergy(dev.index or 0)
    engine = ServeEngine(c, params, n_slots=8, max_len=1024, block_size=16,
                         prefix_cache=True, device=dev,
                         power_methods=[power])
    reqs = serve_requests(c.vocab)
    t0 = time.perf_counter()
    engine.warmup(requests=reqs[:2], repeat=2)   # also crosses a prefix hit
    log(f"[serve] warmup {time.perf_counter() - t0:.1f} s")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.serve(reqs, policy="continuous")
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()

    hits = engine.prefix_stats["hit_requests"]
    check_served(c, engine, out, reqs)
    micro = sum(s.n_steps for s in out.steps if s.kind == "decode")
    assert counts["paged_decode_attention"] == micro * c.n_layers, (
        counts, micro)
    assert counts["paged_prefill_attention"] > 0, counts
    assert hits > 0, engine.prefix_stats

    s = out.summary
    log(f"[serve] {s.n_requests} requests, "
        f"{sum(r.prompt_len for r in out.results)} prompt tokens, "
        f"{s.n_tokens} generated in {wall:.2f} s; prefix hits "
        f"{hits}/{s.n_requests}, "
        f"launches {counts}, decode micro-steps {micro}")
    log_serve("serve", out, wall, power)
    if profile:
        profile_serve(engine, reqs, "serve")
    power.close()
    del engine
    torch.cuda.empty_cache()
    return counts


def phase_serve_int8(dev, c, params, profile: bool = False) -> dict:
    """The serve requests, all arriving at once, through the chunked
    scheduler on an oversubscribed int8 pool: preemption, decode replay,
    and both kernels' int8 paths on every paged call. Then the same run
    on a bf16 pool of as many blocks, which takes the same schedule (so
    the TPOT difference is the int8 path's); the int8-vs-bf16 stream
    agreement is printed, not gated."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import paged_decode_attention
    from repro_torch.kernels.prefill_attention import paged_prefill_attention
    from repro_torch.power.methods import NvmlEnergy
    from repro_torch.serve.engine import ServeEngine

    reqs = [dataclasses.replace(r, arrival_s=0.0)
            for r in serve_requests(c.vocab)]
    runs = {}
    for kv, tag in (("int8", "int8"), ("fp32", "bf16-twin")):
        power = NvmlEnergy(dev.index or 0)
        engine = ServeEngine(c, params, n_slots=8, max_len=1024,
                             block_size=16, n_blocks=INT8_POOL_BLOCKS,
                             prefix_cache=True, kv_dtype=kv,
                             sched="chunked", chunk_tokens=32, device=dev,
                             power_methods=[power])
        t0 = time.perf_counter()
        engine.warmup(requests=reqs[:2], repeat=2)
        log(f"[{tag}] warmup {time.perf_counter() - t0:.1f} s; pool "
            f"{engine._paged.n_blocks} blocks, "
            f"{engine._paged.pool_bytes / 1e6:.1f} MB")

        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = engine.serve(reqs, policy="continuous")
        wall = time.perf_counter() - t0
        counts = dict(ops.launch_counts())
        counts[DECODE_INT8] = paged_decode_attention.launches_int8
        counts[INT8] = paged_prefill_attention.launches_int8

        hits = engine.prefix_stats["hit_requests"]
        check_served(c, engine, out, reqs)
        micro = sum(s.n_steps for s in out.steps if s.kind == "decode")
        sched = (micro, engine.preemptions, engine.replayed_tokens,
                 engine.paged_prefills)
        s = out.summary
        log(f"[{tag}] {s.n_requests} requests, "
            f"{sum(r.prompt_len for r in out.results)} prompt tokens, "
            f"{s.n_tokens} generated in {wall:.2f} s; preemptions "
            f"{engine.preemptions}, replayed tokens "
            f"{engine.replayed_tokens}, prefix hits {hits}, prefill windows "
            f"{sum(1 for st in out.steps if st.kind == 'prefill')} of which "
            f"{engine.paged_prefills} over pool blocks; launches {counts}, "
            f"decode micro-steps {micro}")
        log_serve(tag, out, wall, power)
        if profile and kv == "int8":
            # one trace only: reading ~800k launches back takes minutes
            profile_serve(engine, reqs, tag)
        power.close()
        del engine
        torch.cuda.empty_cache()
        runs[kv] = (sched, counts, {r.rid: list(r.tokens)
                                    for r in out.results})

    (micro, preempts, replayed, paged_calls), counts, streams = runs["int8"]
    assert preempts >= 1 and replayed >= 1, (preempts, replayed)
    assert counts[DECODE_INT8] == counts["paged_decode_attention"] \
        == micro * c.n_layers, (counts, micro)
    assert paged_calls >= 1, paged_calls
    assert counts[INT8] == counts["paged_prefill_attention"] \
        == paged_calls * c.n_layers, (counts, paged_calls)
    assert runs["fp32"][0] == runs["int8"][0], (runs["fp32"][0],
                                                runs["int8"][0])
    assert runs["fp32"][1][DECODE_INT8] == runs["fp32"][1][INT8] == 0
    log(f"[int8] int8 vs bf16 pool stream agreement (recorded, not gated) "
        f"{agreement(streams, runs['fp32'][2]):.4f}")
    return counts


def profile_serve(engine, reqs, tag: str) -> None:
    """Serve the request set again under ``torch.profiler`` and print
    where the time goes: the device-busy share of the wall time and the
    device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engine.reset_prefix_cache()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = engine.serve(reqs, policy="continuous")
        wall = time.perf_counter() - t0
    engine.reset_prefix_cache()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows)
    decode_s = sum(s.duration_s for s in out.steps if s.kind == "decode")
    prefill_s = sum(s.duration_s for s in out.steps if s.kind == "prefill")
    log(f"[profile {tag}] wall {wall:.3f} s (decode windows {decode_s:.3f} "
        f"s, prefill windows {prefill_s:.3f} s), device busy "
        f"{busy_us / 1e6:.3f} s = {busy_us / 1e6 / wall:.3f} of wall, "
        f"{sum(e.count for e in rows)} device launches")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:12]:
        log(f"[profile {tag}] {e.self_device_time_total / 1e3:10.2f} ms "
            f"{e.count:7d}x  {e.key[:90]}")
    for e in rows:
        if any(k in e.key for k in PORT_KERNELS):
            log(f"[profile {tag}] port kernel "
                f"{e.self_device_time_total / 1e3:.2f} ms {e.count}x "
                f"({e.self_device_time_total / max(e.count, 1):.2f} us a "
                f"call)  {e.key[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def agreement(a: dict, b: dict) -> float:
    """Mean longest-common-prefix share of two rid -> stream maps."""
    fracs = []
    for rid, x in a.items():
        y = b[rid]
        lcp = next((i for i, (u, v) in enumerate(zip(x, y)) if u != v),
                   min(len(x), len(y)))
        fracs.append(lcp / max(len(x), len(y), 1))
    return sum(fracs) / len(fracs)


def phase_agreement(dev) -> None:
    """Reduced fp32 model, same weights and requests, prefix cache on:
    the card (kernels) vs the CPU (plain versions) on fp pools and on
    int8 pools (chunked), and the card's chunked scheduler on a pool of
    one full slot plus the trash block (it preempts: the requests arrive
    at once, so the schedule is the same on any device) vs its phased
    one."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.requests import Request

    c = get_config("llama3.2-3b").reduced(dtype="float32",
                                          param_dtype="float32")
    cpu_params = lm.init(c, torch.Generator().manual_seed(1), "cpu")
    params = {"cpu": cpu_params, "cuda": _to(cpu_params, dev)}
    rng = np.random.default_rng(1)
    shared = rng.integers(0, c.vocab, size=32)
    reqs = [Request(rid=i, prompt=np.concatenate(
                [shared, rng.integers(0, c.vocab, size=int(rng.integers(
                    3, 20)))]).astype(np.int32) if i % 2 == 0 else
                rng.integers(0, c.vocab, size=int(rng.integers(
                    8, 40))).astype(np.int32),
                max_new_tokens=int(rng.integers(8, 24)))
            for i in range(12)]
    runs = {
        # name: (device, engine options, sched)
        "fp32 cpu": ("cpu", {}, "phased"),
        "fp32 card": ("cuda", {}, "phased"),
        "int8 cpu": ("cpu", {"kv_dtype": "int8"}, "chunked"),
        "int8 card": ("cuda", {"kv_dtype": "int8"}, "chunked"),
        "chunked card": ("cuda", {"n_blocks": 9}, "chunked"),
    }
    streams = {}
    for name, (where, kw, sched) in runs.items():
        eng = ServeEngine(c, params[where], n_slots=4, max_len=128,
                          block_size=16, prefix_cache=True, device=where,
                          **kw)
        out = eng.serve(reqs, sched=sched)
        assert eng.prefix_stats["hit_requests"] > 0, name
        assert all(r.n_tokens == q.max_new_tokens for r, q in zip(
            sorted(out.results, key=lambda r: r.rid), reqs)), name
        streams[name] = {r.rid: list(r.tokens) for r in out.results}
        log(f"[agreement] {name}: {sched}, preemptions {eng.preemptions}, "
            f"replayed tokens {eng.replayed_tokens}, prefills over pool "
            f"blocks {eng.paged_prefills}")
        if "n_blocks" in kw:
            assert eng.preemptions >= 1 and eng.replayed_tokens >= 1, name
    for a, b in (("fp32 cpu", "fp32 card"), ("int8 cpu", "int8 card"),
                 ("fp32 card", "chunked card")):
        agree = agreement(streams[a], streams[b])
        log(f"[agreement] reduced fp32 {c.name}: {b} vs {a} stream "
            f"agreement {agree:.4f} over {len(reqs)} requests")
        assert agree >= STREAM_AGREEMENT, (a, b, agree)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def phase_bench() -> dict:
    """The ``kernels`` workload through the port's benchmark CLI on the
    card, full Space (the reference's cases and the llama3.2-3b ones).
    Returns the launches counted in this run, per kernel."""
    from repro_torch.bench import cli
    from repro_torch.bench.records import load_records
    from repro_torch.bench.workloads.kernels import CASES
    from repro_torch.kernels import ops
    from repro_torch.kernels.prefill_attention import paged_prefill_attention
    with tempfile.TemporaryDirectory() as out:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(["run", "--suite", "kernels", "--device", "cuda",
                       "--power", "none", "--out", out, "--quiet"])
        wall = time.perf_counter() - t0
        counts = dict(ops.launch_counts())
        counts[INT8] = paged_prefill_attention.launches_int8
        records = load_records(f"{out}/kernels/results.json")
    assert rc == 0, rc
    assert [(r.point["case"], r.point["impl"]) for r in records] == [
        (c, i) for c in CASES for i in ("plain", "cuda")], records
    for r in records:
        assert r.status == "ok", (r.point, r.error)
        m = r.metrics
        line = (f"[bench] {r.point['case']:27s} {r.point['impl']:5s} "
                f"{m['dtype']:8s} us={m['us']:.3f}")
        if r.point["impl"] == "cuda":
            dtype = getattr(torch, m["dtype"])
            line += (f" max_err={m['max_err']:.3e} max_err_ratio="
                     f"{m['max_err_ratio']:.3e} mismatch_share="
                     f"{m['mismatch_share']:.3e}")
            assert m["max_err_ratio"] <= TOL[dtype], line
            assert (dtype != torch.bfloat16
                    or m["mismatch_share"] <= MAX_BF16_MISMATCH_SHARE), line
        log(line)
    log(f"[bench] {len(records)} records ok in {wall:.1f} s; launches "
        f"{counts}")
    for name in ("flash_attention", "rmsnorm", "paged_prefill_attention",
                 INT8):
        assert counts[name] > 0, (name, counts)
    return counts


def run_workload(name: str, points: str, out: str) -> list:
    """One serve workload through the port's bench CLI on the card (its
    smoke preset narrowed by ``points``); returns its records."""
    from repro_torch.bench import cli
    from repro_torch.bench.records import load_records
    t0 = time.perf_counter()
    rc = cli.main(["run", "--suite", name, "--smoke", "--points", points,
                   "--device", "cuda", "--power", "auto", "--out", out,
                   "--quiet"])
    log(f"[{name}] --points {points}: rc {rc} in "
        f"{time.perf_counter() - t0:.1f} s")
    assert rc == 0, (name, rc)
    return load_records(f"{out}/{name}/results.json")


def log_record(name: str, r) -> None:
    """A record's cell and headline columns on one line."""
    m = r.metrics
    cell = "/".join(f"{k}={v}" for k, v in r.point.items() if k != "arch")
    cols = ["decode_tok_s", "ttft_s", "ttft_p99", "tpot_p99", "goodput",
            "wh_per_token", "wh_per_slo_request", "occupancy",
            "preemptions", "kv_stream_prefix_agreement"]
    cols += sorted(k for k in m if k.startswith(("speedup_vs_",
                                                 "ttft_p99_vs_",
                                                 "wh_per_slo_vs_",
                                                 "goodput_vs_",
                                                 "stream_agreement_")))
    vals = " ".join(f"{k}={m[k]:.6g}" for k in cols if k in m)
    log(f"[{name}] {cell}: {vals} n_tokens={m['n_tokens']} "
        f"micro_steps={m['decode_micro_steps']} launches decode "
        f"{m['decode_launches']} (int8 {m['decode_launches_int8']}) "
        f"prefill {m['prefill_launches']} (int8 "
        f"{m['prefill_launches_int8']}) wall_s={m['wall_s']:.3f} "
        f"rel_spread={r.noise['rel_std']} power_source={r.power_source} "
        f"model_scale={m['model_scale']} n_params={m['n_params']}")


def check_workload_record(name: str, r, n_layers: int) -> None:
    """The kernels a record's measured run must (and must not) have
    launched, by its cell."""
    m, pt = r.metrics, r.point
    assert r.status == "ok", (name, pt, r.error)
    assert r.power_source == "nvml_energy", (name, pt, r.power_source)
    assert m["model_scale"] == "full", (name, pt)
    if pt.get("cache", "paged").startswith("paged"):
        int8 = pt["kv_dtype"] == "int8"
        assert m["decode_launches"] == n_layers * m["decode_micro_steps"] \
            > 0, (name, pt, m)
        assert m["decode_launches_int8"] == (m["decode_launches"] if int8
                                             else 0), (name, pt, m)
        assert m["prefill_launches"] == n_layers * m["paged_prefills"], \
            (name, pt, m)
        assert m["prefill_launches_int8"] == (m["prefill_launches"] if int8
                                              else 0), (name, pt, m)
    else:                       # slotted: sdpa over dense rows, no kernel
        assert m["decode_launches"] == m["prefill_launches"] == 0, (name, pt)


def phase_workloads(dev, c, profile: bool = False) -> dict:
    """The serve and serve_slo workloads through the port's bench CLI at
    full width (see the module docstring); returns the launches counted
    over the phase, per kernel."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import paged_decode_attention
    from repro_torch.kernels.prefill_attention import paged_prefill_attention
    with tempfile.TemporaryDirectory() as out:
        ops.reset_launch_counts()
        records = {"serve": run_workload("serve", SERVE_POINTS, out),
                   "serve_slo": [r for i, pts in enumerate(SLO_POINTS)
                                 for r in run_workload("serve_slo", pts,
                                                       f"{out}/{i}")]}
        counts = dict(ops.launch_counts())
        counts[DECODE_INT8] = paged_decode_attention.launches_int8
        counts[INT8] = paged_prefill_attention.launches_int8
    for name, recs in records.items():
        for r in recs:
            log_record(name, r)
    for name, recs in records.items():
        for r in recs:
            check_workload_record(name, r, c.n_layers)
    cells = {(r.point["cache"], r.point["policy"], r.point["kv_dtype"],
              r.point["sched"]) for r in records["serve"]}
    assert {("paged", "continuous", "fp32", "phased"),
            ("slotted", "continuous", "fp32", "phased"),
            ("paged", "continuous", "int8", "phased"),
            ("paged", "continuous", "fp32", "chunked")} <= cells, cells
    assert all("speedup_vs_fixed" in r.metrics for r in records["serve"])
    slo = {(r.point["trace"], r.point["cache"], r.point["sched"]): r.metrics
           for r in records["serve_slo"]}
    chunked = slo["long_prefill", "paged", "chunked"]
    phased = slo["long_prefill", "paged", "phased"]
    hits = slo["shared_prefix", "paged+prefix", "phased"]
    log(f"[workloads] long_prefill stream_hash phased "
        f"{phased['stream_hash']} chunked {chunked['stream_hash']}, "
        f"agreement {chunked['stream_agreement_vs_phased']:.4f}; "
        f"shared_prefix paged+prefix vs paged agreement "
        f"{hits['stream_agreement_vs_paged']:.4f}")
    assert chunked["preemptions"] >= 1, chunked
    assert chunked["prefill_launches"] > 0, chunked
    assert chunked["n_tokens"] == phased["n_tokens"], (chunked, phased)
    # the chunks after the first run the prefill kernel (fp32 scores)
    # where phased runs bf16 sdpa over the whole prompt, so in bf16 a
    # near-tie may flip (equal hashes hold on the CPU, in the tests): the
    # streams are held to phase 3's agreement instead of equal hashes
    assert chunked["stream_agreement_vs_phased"] >= STREAM_AGREEMENT, chunked
    # where both schedulers run the same arithmetic (every serve prompt
    # fits one chunk, no preemption) the streams are equal, bit for bit
    serve_chunked = [r.metrics for r in records["serve"]
                     if r.point["cache"] == "paged"
                     and r.point["kv_dtype"] == "fp32"
                     and r.point["sched"] == "chunked"]
    assert serve_chunked and all(m["stream_agreement_vs_phased"] == 1.0
                                 for m in serve_chunked), serve_chunked
    assert hits["prefix_hit_requests"] > 0 and hits["prefill_launches"] > 0
    for name in ("paged_decode_attention", DECODE_INT8,
                 "paged_prefill_attention"):
        assert counts[name] > 0, (name, counts)
    log(f"[workloads] {sum(map(len, records.values()))} records ok; "
        f"launches {counts}")
    if profile:
        profile_main_cell(dev)
    return counts


def profile_main_cell(dev) -> None:
    """The serve workload's main-path cell (its engine and requests)
    under ``torch.profiler``: its device-busy share beside its wall."""
    from repro_torch.bench.context import RunContext
    from repro_torch.bench.workloads import serve as wl
    from repro_torch.serve.requests import poisson_requests
    ctx = RunContext(device=dev, smoke=True)
    c, engine = wl._engine(ctx, "llama3.2-3b", 4, "paged")
    reqs = poisson_requests(wl.N_REQUESTS_SMOKE, 300.0, c.vocab,
                            prompt_len=wl.PROMPT_LEN, seed=wl.SEED)
    profile_serve(engine, reqs, "serve cell paged/continuous/phased/fp32")
    del engine, ctx
    torch.cuda.empty_cache()


def model_flop_share(n_params: int, tokens: int, seconds: float) -> float:
    """8 N tokens (forward, backward and the full-remat forward again)
    over the step time, against the card's dense bf16 peak."""
    return 8 * n_params * tokens / seconds / PEAK_FLOPS[torch.bfloat16]


def phase_train(dev, profile: bool = False) -> None:
    """The training path at full width (see the module docstring)."""
    from repro_torch.bench import cli
    from repro_torch.bench.records import load_records
    t_phase = t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        rc = cli.main(["run", "--suite", "llm_train", "--points",
                       "placement=dp1", "--device", "cuda", "--power",
                       "auto", "--iters", str(TRAIN_ITERS), "--out", out,
                       "--quiet"])
        records = load_records(f"{out}/llm_train/results.json")
    log(f"[train] llm_train dp1 Space: rc {rc}, {len(records)} records in "
        f"{time.perf_counter() - t0:.1f} s")
    assert rc == 0, rc
    assert sorted((r.point["global_batch"], r.point["grad_sync"])
                  for r in records) == [(gb, g) for gb in (16, 32, 64)
                                        for g in ("fp32", "int8")], records
    for r in records:
        m, pt = r.metrics, r.point
        tokens = pt["global_batch"] * pt["seq"]
        log(f"[train] llm_train gb={pt['global_batch']} seq={pt['seq']} "
            f"grad_sync={pt['grad_sync']} k={m.get('microbatches')}: "
            f"tokens_per_s={m.get('tokens_per_s', 0):.1f} "
            f"ms_per_step={m.get('ms_per_step', 0):.3f} "
            f"energy_wh_per_step={m.get('energy_wh_per_step', 0):.6e} "
            f"tokens_per_wh={m.get('tokens_per_wh', 0):.1f} "
            f"peak_mem_gb={m.get('peak_mem_gb', 0):.2f} "
            f"model_flop_share="
            f"{model_flop_share(m['n_params'], tokens, m['seconds']):.4f} "
            f"loss {m.get('loss_first', 0):.4f} -> "
            f"{m.get('loss_last', 0):.4f} rel_spread={r.noise['rel_std']} "
            f"power_source={r.power_source} model_scale="
            f"{m.get('model_scale')} n_params={m.get('n_params')}")
    for r in records:
        m = r.metrics
        assert r.status == "ok", (r.point, r.error)
        assert r.power_source == "nvml_energy", (r.point, r.power_source)
        assert m["model_scale"] == "full", r.point
        assert m["loss_last"] < m["loss_first"], (r.point, m)
        assert math.isfinite(m["tokens_per_wh"]) and m["tokens_per_wh"] > 0
    del records
    gc.collect()
    torch.cuda.empty_cache()
    train_agreement(dev)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        rc = cli.main(["run", "--suite", "resilience", "--smoke", "--device",
                       "cuda", "--power", "auto", "--out", out, "--quiet"])
        records = load_records(f"{out}/resilience/results.json")
    log(f"[train] resilience smoke: rc {rc}, {len(records)} records in "
        f"{time.perf_counter() - t0:.1f} s")
    assert rc == 0, rc
    for r in records:
        m = r.metrics
        log(f"[train] resilience {r.point['fault_preset']} ckpt_every="
            f"{r.point['ckpt_every']}: final_step={m.get('final_step')} "
            f"restarts={m.get('restarts')} recovery_s={m.get('recovery_s')} "
            f"backoff_s={m.get('backoff_s')} wasted_tokens="
            f"{m.get('wasted_tokens')} goodput_tokens_per_s="
            f"{m.get('goodput_tokens_per_s', 0):.1f} energy_wh="
            f"{m.get('energy_wh', 0):.6e} wh_overhead_resilience="
            f"{m.get('wh_overhead_resilience', 0):.6e} twin_wall_s="
            f"{m.get('twin_wall_s', 0):.3f} loss_bitmatch="
            f"{m.get('loss_bitmatch')} final_loss={m.get('final_loss')} "
            f"schedule_hash={m.get('schedule_hash')} power_source="
            f"{r.power_source} model_scale={m.get('model_scale')} "
            f"n_params={m.get('n_params')}")
    for r in records:
        assert r.status == "ok", (r.point, r.error)
        assert r.power_source == "nvml_energy", (r.point, r.power_source)
        assert r.metrics["model_scale"] == "full", r.point
        assert r.metrics["loss_bitmatch"] == 1.0, (r.point, r.metrics)
    crash = [r.metrics for r in records
             if r.point["fault_preset"] == "crash_mid"]
    assert crash and all(m["restarts"] >= 1 for m in crash), crash
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[wall] phase 7 {time.perf_counter() - t_phase:.1f} s")
    if profile:
        profile_train_step(dev)


def train_agreement(dev) -> None:
    """Reduced fp32 gpt-800m, three AdamW steps of 4 microbatches from
    the same weights and batches on the card and on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.launch.train import make_data_fn
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import (StepConfig, init_train_state,
                                        make_train_step)
    c = get_config("gpt-800m").reduced(dtype="float32",
                                       param_dtype="float32")
    oc = OptConfig(warmup=2, total_steps=1000)
    step = make_train_step(c, oc, StepConfig(microbatches=4))
    cpu = torch.device("cpu")
    state = {cpu: init_train_state(c, oc, torch.Generator().manual_seed(0),
                                   cpu)}
    state[dev] = tree.tree_map(lambda t: t.to(dev), state[cpu])
    losses = {}
    for d in (cpu, dev):
        p, o = state[d]
        data = make_data_fn(c, 8, 64, seed=0, device=d)
        losses[d] = []
        for i in range(3):
            p, o, m = step(p, o, data(i))
            losses[d].append(float(m["loss"]))
    diffs = [(a.cpu() - b).abs() for a, b in
             zip(tree.leaves(state[dev][0]), tree.leaves(state[cpu][0]))]
    worst = max(d.max().item() for d in diffs)
    share = (sum((d > 1e-6).sum().item() for d in diffs)
             / sum(d.numel() for d in diffs))
    log(f"[train] reduced fp32 {c.name}, 3 AdamW steps: card losses "
        f"{losses[dev]}, cpu {losses[cpu]}; params max |diff| "
        f"{worst:.3e}, share of elements differing by > 1e-6 {share:.3e}")
    np.testing.assert_allclose(losses[dev], losses[cpu], rtol=1e-4)


def _subtree_kernels(e) -> list:
    out = list(e.kernels)
    for ch in e.cpu_children:
        out += _subtree_kernels(ch)
    return out


def _kernel_kind(name: str) -> str:
    n = name.lower()
    if n.startswith(("memcpy", "memset")) or "copy_kernel" in n:
        return "copies"
    if any(k in n for k in ("gemm", "xmma", "nvjet", "cutlass", "cublas")):
        return "gemms"
    return "elementwise"


def profile_train_step(dev) -> None:
    """One full-width gpt-800m step at global batch 64 (the llm_train
    fp32 cell: 4 microbatches, overlapped bucket sync) under
    ``torch.profiler``: the device-busy share of its wall, and its
    device time by kind (kernels launched inside the ``optimizer`` range
    count as optimizer), beside the optimizer's bound from its bytes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.data.synthetic import synthetic_tokens
    from repro_torch.parallel import grad_sync as gs
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import StepConfig, init_train_state
    c = get_config("gpt-800m")
    oc = OptConfig(warmup=2, total_steps=1000)
    p, o = init_train_state(c, oc, torch.Generator(device=dev).manual_seed(0),
                            dev)
    n_params = sum(t.numel() for t in tree.leaves(p))
    sync = gs.default_sync("fp32", dev)
    step = gs.make_dp_train_step(c, oc, StepConfig(microbatches=4),
                                 sync=sync)
    s = gs.init_sync_state(p, sync)
    gb, seq = 64, 128
    toks = torch.from_numpy(synthetic_tokens(gb, seq, c.vocab)[:, :seq])
    batch = {"tokens": toks.to(dev), "labels": torch.roll(toks, -1, 1)
             .to(dev)}
    for _ in range(2):                      # warm: allocator, handles
        p, o, s, m = step(p, o, s, batch)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        p, o, s, m = step(p, o, s, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in TRAIN_RANGES]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_kind = dict.fromkeys(("gemms", "elementwise", "copies"), 0.0)
    for e in kernels:
        by_kind[_kernel_kind(e.name)] += e.time_range.elapsed_us() / 1e3
    ranges = {}
    for name in TRAIN_RANGES:
        ks = [k for e in events if e.name == name
              and e.device_type == DeviceType.CPU
              for k in _subtree_kernels(e)]
        ranges[name] = sum(k.duration for k in ks) / 1e3
        if name == "optimizer":
            for k in ks:                      # optimizer counts apart
                by_kind[_kernel_kind(k.name)] -= k.duration / 1e3
    by_kind["optimizer"] = ranges["optimizer"]
    opt_bound = ADAMW_BYTES_PER_PARAM * n_params / HBM_BYTES_PER_S * 1e3
    log(f"[profile train] gpt-800m gb={gb} seq={seq} k=4 fp32 sync: wall "
        f"{wall * 1e3:.2f} ms (profiled), device busy {busy:.2f} ms = "
        f"{busy / 1e3 / wall:.4f} of wall, {len(kernels)} device events; "
        f"model-FLOP share over the profiled wall "
        f"{model_flop_share(n_params, gb * seq, wall):.4f}")
    log("[profile train] device ms by kind: " + ", ".join(
        f"{k} {v:.2f} ({v / busy:.3f})" for k, v in by_kind.items()))
    log("[profile train] device ms by range: " + ", ".join(
        f"{k} {v:.2f}" for k, v in ranges.items())
        + f"; optimizer bound from its bytes "
          f"({ADAMW_BYTES_PER_PARAM} B x {n_params / 1e6:.1f}M params) "
          f"{opt_bound:.2f} ms")
    rows = prof.key_averages()
    rows = sorted((e for e in rows if e.device_type == DeviceType.CUDA
                   and e.key not in TRAIN_RANGES),
                  key=lambda e: -e.self_device_time_total)
    for e in rows[:15]:
        log(f"[profile train] {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:6d}x  {e.key[:100]}")
    del p, o, s
    gc.collect()
    torch.cuda.empty_cache()


def phase_times(dev, counts: dict, int8_counts: dict, bench_counts: dict,
                errs: dict) -> list:
    """Each kernel at main-path shapes: its time, its plain version's,
    the library yardstick's, and the bound from the bytes and flops it
    needs; the kernel's and the library's device time warm and cold
    (``device_times``), and for decode and RMSNorm the wrapper's host
    time. ``counts`` are the fp serve run's launches, ``int8_counts`` the
    int8 chunked serve run's, ``bench_counts`` the bench run's."""
    import torch.nn.functional as F
    from repro_torch.bench.workloads.kernels import plain_fp32
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(2)
    dtype = torch.bfloat16
    esize = 2
    rows = []

    def measure(kernel, args, kw, read_bytes, lib, lib_args, lib_kw, *,
                host_args=None) -> dict:
        """Device times of the kernel and the library call; with
        ``host_args``, light inputs that take the same wrapper path, the
        wrapper's host time too."""
        warm, cold = device_times(kernel, args, kw, read_bytes)
        lwarm, lcold = device_times(lib, lib_args, lib_kw,
                                    tensor_bytes(lib_args, lib_kw))
        out = {"device_ms": warm, "device_ms_cold": cold,
               "library_device_ms": lwarm, "library_device_ms_cold": lcold}
        if host_args is not None:
            out["host_us"] = host_us(lambda: kernel(*host_args, **kw))
        return out

    def sdpa_cut(qd, gather, lens, dev_t) -> None:
        """SDPA on K/V cut to the longest sequence's table columns
        (``gather(cols)`` gives them), beside the full-table yardstick."""
        cols = -(-int(lens.max()) // BS)
        kc, vc = gather(cols)
        cut_kw = dict(attn_mask=(torch.arange(cols * BS, device=dev)[None]
                                 < lens[:, None]).reshape(B, 1, 1, -1),
                      enable_gqa=True)
        warm, cold = device_times(F.scaled_dot_product_attention,
                                  (qd, kc, vc), cut_kw,
                                  tensor_bytes((qd, kc, vc), cut_kw))
        dev_t.update(library_cut_device_ms=warm,
                     library_cut_device_ms_cold=cold,
                     library_cut_keys=cols * BS)

    def one_token(args):
        """Decode inputs with every length 1: the same wrapper path (B,
        table width, splits), a kernel of a few microseconds."""
        return (*args[:4], torch.ones_like(args[4]))

    # decode: B=8 slots of a serve mix (prompt 64-512 + up to 64 tokens)
    lengths = rng.integers(64, 577, size=B)
    (q, kp, vp, tables, lens), _ = decode_case(rng, lengths, dtype, dev)
    check_kernel("paged_decode_attention", errs,
                 ops.paged_decode_attention(q, kp, vp, tables, lens),
                 plain_fp32(ref.paged_decode_attention_ref, q, kp, vp,
                            tables, lens), dtype, "at the timed shapes")
    ms = time_ms(lambda: ops.paged_decode_attention(q, kp, vp, tables, lens))
    plain = time_ms(lambda: ref.paged_decode_attention_ref(
        q, kp, vp, tables, lens), iters=10)
    nb = tables.shape[1]
    kd = kp[tables.long()].reshape(B, nb * BS, KH, DH).transpose(1, 2)
    vd = vp[tables.long()].reshape(B, nb * BS, KH, DH).transpose(1, 2)
    mask = (torch.arange(nb * BS, device=dev)[None, :]
            < lens[:, None]).reshape(B, 1, 1, nb * BS)
    qd = q.reshape(B, H, 1, DH)
    sdpa_kw = dict(attn_mask=mask, enable_gqa=True)
    lib = time_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                         **sdpa_kw))
    tok = int(lengths.sum())
    nbytes = (2 * B * H * DH * esize + 2 * tok * KH * DH * esize
              + sum(-(-int(n) // BS) for n in lengths) * 4 + B * 4)
    dev_t = measure(ops.paged_decode_attention, (q, kp, vp, tables, lens),
                    {}, nbytes, F.scaled_dot_product_attention,
                    (qd, kd, vd), sdpa_kw,
                    host_args=one_token((q, kp, vp, tables, lens)))
    sdpa_cut(qd, lambda c: tuple(
        p[tables[:, :c].long()].reshape(B, c * BS, KH, DH).transpose(1, 2)
        for p in (kp, vp)), lens, dev_t)
    flops = 4 * tok * H * DH
    rows.append(_row("paged_decode_attention", "decode_attention", counts,
                     errs, ms, plain, lib, nbytes, flops, dtype,
                     f"B={B} H={H} Kh={KH} Dh={DH} bs={BS} nb={nb} "
                     f"lengths={lengths.tolist()}", dev_t))

    # the same decode on an int8 pool; SDPA runs on K/V gathered and
    # dequantized beforehand (not timed)
    args, kw = decode_case(rng, lengths, dtype, dev, int8=True)
    check_kernel(DECODE_INT8, errs, ops.paged_decode_attention(*args, **kw),
                 plain_fp32(ref.paged_decode_attention_ref, *args, **kw),
                 dtype, "at the timed shapes")
    ms = time_ms(lambda: ops.paged_decode_attention(*args, **kw))
    plain = time_ms(lambda: ref.paged_decode_attention_ref(*args, **kw),
                    iters=10)
    q, kp, vp, tables, lens = args
    deq = lambda p, s: ref.dequantize_pool(p, tables, s).reshape(
        B, nb * BS, KH, DH).transpose(1, 2).to(dtype)
    kd, vd = deq(kp, kw["k_scale"]), deq(vp, kw["v_scale"])
    qd = q.reshape(B, H, 1, DH)
    lib = time_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                         **sdpa_kw))
    n_read = sum(-(-int(n) // BS) for n in lengths)
    nbytes = (2 * B * H * DH * esize + 2 * tok * KH * DH
              + 2 * n_read * KH * 4 + n_read * 4 + B * 4)
    dev_t = measure(ops.paged_decode_attention, args, kw, nbytes,
                    F.scaled_dot_product_attention, (qd, kd, vd), sdpa_kw,
                    host_args=one_token(args))
    sdpa_cut(qd, lambda c: tuple(
        ref.dequantize_pool(p, tables[:, :c], sc).reshape(
            B, c * BS, KH, DH).transpose(1, 2).to(dtype)
        for p, sc in ((kp, kw["k_scale"]), (vp, kw["v_scale"]))), lens,
        dev_t)
    rows.append(_row(DECODE_INT8, "decode_attention", int8_counts, errs, ms,
                     plain, lib, nbytes, flops, dtype,
                     f"B={B} H={H} Kh={KH} Dh={DH} bs={BS} nb={nb} "
                     f"lengths={lengths.tolist()}, int8 pool", dev_t,
                     source="src/repro_torch/csrc/paged_decode_attention.cu"))

    # prefill: a prefix-cache hit of the serve mix, 16 shared blocks +
    # a 128-token suffix bucket, batch padded to 8 slots (one pad row)
    npre, sq = 16, 128
    args, _ = prefill_case(rng, npre, sq, dtype, dev)
    check_kernel("paged_prefill_attention", errs,
                 ops.paged_prefill_attention(*args),
                 plain_fp32(ref.paged_prefill_attention_ref, *args), dtype,
                 "at the timed shapes")
    ms = time_ms(lambda: ops.paged_prefill_attention(*args))
    plain = time_ms(lambda: ref.paged_prefill_attention_ref(*args), iters=10)
    q, ks, vs, kp, vp, tables = args
    pre = npre * BS
    kd = torch.cat([kp[tables.long()].reshape(B, pre, KH, DH), ks],
                   1).transpose(1, 2).contiguous()
    vd = torch.cat([vp[tables.long()].reshape(B, pre, KH, DH), vs],
                   1).transpose(1, 2).contiguous()
    qd = q.transpose(1, 2).contiguous()
    mask = (torch.arange(pre + sq, device=dev)[None, :]
            <= torch.arange(sq, device=dev)[:, None] + pre)
    sdpa_kw = dict(attn_mask=mask, enable_gqa=True)
    lib = time_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                         **sdpa_kw))
    n_read = torch.unique(tables).numel()      # the pad row reads block 0
    nbytes = (2 * B * sq * H * DH * esize + 2 * B * sq * KH * DH * esize
              + 2 * n_read * BS * KH * DH * esize + B * npre * 4)
    dev_t = measure(ops.paged_prefill_attention, args, {}, nbytes,
                    F.scaled_dot_product_attention, (qd, kd, vd), sdpa_kw)
    flops = 4 * H * DH * B * sum(pre + i + 1 for i in range(sq))
    rows.append(_row("paged_prefill_attention", "prefill_attention", counts,
                     errs, ms, plain, lib, nbytes, flops, dtype,
                     f"B={B} Sq={sq} npre={npre} H={H} Kh={KH} Dh={DH} "
                     f"bs={BS}", dev_t))

    # the same prefix hit on an int8 pool; SDPA runs on the view
    # dequantized and gathered beforehand (not timed)
    args, kw = prefill_case(rng, npre, sq, dtype, dev, int8=True)
    check_kernel(INT8, errs, ops.paged_prefill_attention(*args, **kw),
                 plain_fp32(ref.paged_prefill_attention_ref, *args, **kw),
                 dtype, "at the timed shapes")
    ms = time_ms(lambda: ops.paged_prefill_attention(*args, **kw))
    plain = time_ms(lambda: ref.paged_prefill_attention_ref(*args, **kw),
                    iters=10)
    q, ks, vs, kp, vp, tables = args
    deq = lambda p, s: ref.dequantize_pool(p, tables, s).reshape(
        B, pre, KH, DH).to(dtype)
    kd = torch.cat([deq(kp, kw["k_scale"]), ks], 1).transpose(1, 2) \
        .contiguous()
    vd = torch.cat([deq(vp, kw["v_scale"]), vs], 1).transpose(1, 2) \
        .contiguous()
    qd = q.transpose(1, 2).contiguous()
    lib = time_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                         **sdpa_kw))
    n_read = torch.unique(tables).numel()
    nbytes = (2 * B * sq * H * DH * esize + 2 * B * sq * KH * DH * esize
              + 2 * n_read * BS * KH * DH + 2 * n_read * KH * 4
              + B * npre * 4)
    dev_t = measure(ops.paged_prefill_attention, args, kw, nbytes,
                    F.scaled_dot_product_attention, (qd, kd, vd), sdpa_kw)
    rows.append(_row(INT8, "prefill_attention", bench_counts, errs, ms,
                     plain, lib, nbytes, flops, dtype,
                     f"B={B} Sq={sq} npre={npre} H={H} Kh={KH} Dh={DH} "
                     f"bs={BS}, int8 pool", dev_t,
                     source="src/repro_torch/csrc/paged_prefill_attention.cu"))

    # flash: a 2048-token causal prefill at llama3.2-3b width; SDPA runs
    # on (B, H, S, Dh) views of the same tensors
    fb, s = 2, 2048
    q = torch.randn(fb, s, H, DH, device=dev).to(dtype)
    k = torch.randn(fb, s, KH, DH, device=dev).to(dtype)
    v = torch.randn(fb, s, KH, DH, device=dev).to(dtype)
    check_kernel("flash_attention", errs, ops.flash_attention(q, k, v),
                 plain_fp32(ref.flash_attention_ref, q, k, v), dtype,
                 "at the timed shapes")
    ms = time_ms(lambda: ops.flash_attention(q, k, v))
    plain = time_ms(lambda: ref.flash_attention_ref(q, k, v), iters=10)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_kw = dict(is_causal=True, enable_gqa=True)
    lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         **sdpa_kw))
    nbytes = (2 * fb * s * H * DH + 2 * fb * s * KH * DH) * esize
    dev_t = measure(ops.flash_attention, (q, k, v), {}, nbytes,
                    F.scaled_dot_product_attention, (qt, kt, vt), sdpa_kw)
    flops = 4 * fb * H * DH * s * (s + 1) // 2
    rows.append(_row("flash_attention", "flash_attention", bench_counts,
                     errs, ms, plain, lib, nbytes, flops, dtype,
                     f"B={fb} S={s} H={H} Kh={KH} Dh={DH} causal", dev_t))

    # rmsnorm: 4096 tokens at d_model 3072, bf16 weight; its few
    # operations per element run in fp32 on the CUDA cores
    rn, d = 4096, 3072
    x = torch.randn(rn, d, device=dev).to(dtype)
    w = torch.randn(d, device=dev).to(dtype)
    check_kernel("rmsnorm", errs, ops.rmsnorm(x, w),
                 plain_fp32(ref.rmsnorm_ref, x, w), dtype,
                 "at the timed shapes")
    ms = time_ms(lambda: ops.rmsnorm(x, w))
    plain = time_ms(lambda: ref.rmsnorm_ref(x, w), iters=10)
    lib = time_ms(lambda: F.rms_norm(x, (d,), weight=w, eps=1e-5))
    nbytes = 2 * rn * d * esize + d * esize
    dev_t = measure(ops.rmsnorm, (x, w), {}, rn * d * esize, F.rms_norm,
                    (x, (d,)), dict(weight=w, eps=1e-5), host_args=(x[:8], w))
    rows.append(_row("rmsnorm", "rmsnorm", bench_counts, errs, ms, plain,
                     lib, nbytes, 4 * rn * d, torch.float32,
                     f"rows={rn} d={d}", dev_t))
    return rows


REPLACES = {
    "paged_decode_attention": "src/repro/kernels/decode_attention.py:155",
    "paged_prefill_attention": "src/repro/kernels/prefill_attention.py:217",
    INT8: "src/repro/kernels/prefill_attention.py:217",
    DECODE_INT8: "src/repro/kernels/decode_attention.py:155",
    "flash_attention": "src/repro/kernels/flash_attention.py:106",
    "rmsnorm": "src/repro/kernels/rmsnorm.py:40",
}


def _row(name, module, counts, errs, ms, plain, lib, nbytes, flops,
         peak_dtype, shape, dev_t, source=None):
    """One JSON row; the bound is the larger of the bytes over HBM rate
    and the operations over the peak rate of ``peak_dtype``; ``tflops``
    is the operations over the kernel's device time, warm; ``dev_t`` the
    device (and host) times of ``phase_times``."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[peak_dtype] * 1e3
    row = {"name": name, "route": "cuda",
           "source": source or f"src/repro_torch/csrc/{name}.cu",
           "replaces": REPLACES[name],
           "launches": None if counts is None else counts[name],
           "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": lib, **dev_t,
           "tflops": flops / dev_t["device_ms"] / 1e9}
    host = (f"; wrapper host {dev_t['host_us']:.2f} us a call"
            if "host_us" in dev_t else "")
    if "library_cut_device_ms" in dev_t:
        host += (f"; library on K/V cut to {dev_t['library_cut_keys']} "
                 f"keys {dev_t['library_cut_device_ms']:.4f} ms warm, "
                 f"{dev_t['library_cut_device_ms_cold']:.4f} cold")
    log(f"[times] {name} ({module}.py) at {shape}: kernel {ms:.4f} ms "
        f"(events over 50 calls), device {dev_t['device_ms']:.4f} ms warm, "
        f"{dev_t['device_ms_cold']:.4f} ms cold (bound / cold "
        f"{row['bound_ms'] / dev_t['device_ms_cold']:.3f}); "
        f"plain {plain:.4f} ms, library {lib:.4f} ms (device "
        f"{dev_t['library_device_ms']:.4f} warm, "
        f"{dev_t['library_device_ms_cold']:.4f} cold), bound "
        f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
        f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP); "
        f"{row['tflops']:.2f} TFLOP/s{host}; launches {row['launches']}")
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = time.perf_counter()
    if "--train" in sys.argv[1:]:
        phase_train(dev, profile="--profile" in sys.argv[1:])
        log(f"[wall] phase 7 alone {time.perf_counter() - t_start:.1f} s")
        print(card_line(), flush=True)
        return 0
    t0 = time.perf_counter()
    _build.load_library()
    log(f"[build] nvcc sm_90a build + load {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "bytes stack" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")
    if "--times" in sys.argv[1:]:
        rows = phase_times(dev, None, None, None,
                           dict.fromkeys(REPLACES, 0.0))
        for row in rows:            # neither is measured by phase 5 alone
            del row["launches"], row["max_abs_err"]
        print(json.dumps({"times": rows}), flush=True)
        print(card_line(), flush=True)
        return 0
    check_build(_build)

    errs = phase_kernels(dev)
    c, params = full_model(dev)
    counts = phase_serve(dev, c, params, profile="--profile" in sys.argv[1:])
    int8_counts = phase_serve_int8(dev, c, params,
                                   profile="--profile" in sys.argv[1:])
    del params
    torch.cuda.empty_cache()
    phase_agreement(dev)
    bench_counts = phase_bench()
    rows = phase_times(dev, counts, int8_counts, bench_counts, errs)
    phase_workloads(dev, c, profile="--profile" in sys.argv[1:])
    phase_train(dev, profile="--profile" in sys.argv[1:])
    log(f"[wall] chip_smoke {time.perf_counter() - t_start:.1f} s, the "
        f"kernels' build included")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
