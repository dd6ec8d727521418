#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py [--profile | --times | --train [--profile] |
                         --families [--profile] | --generate [--profile] |
                         --harness | --dryrun | --parallel]

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
sm_90a) and checks that the bf16 tensor-core kernels (flash attention
and paged prefill on ``csrc/attention_mma.cuh``) issue
``HMMA.16816.F32.BF16`` in the library's SASS and that they, the paged
decode kernel and both RMSNorm kernels spill no register in any
instance, then runs fourteen phases, any failure of which exits non-zero:

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
     ``serve_slo``, twice) ``--smoke --power auto --layers SERVE_LAYERS``
     in process, at full llama3.2-3b width cut to ``SERVE_LAYERS`` of its
     28 layers (every record must say so: ``n_layers``,
     ``model_scale=full_width``), on NVML's energy counter, narrowed by
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
     and headline columns, and the phase its wall time (``--profile``
     also traces the main-path cell and prints its device-busy share:
     ~6 min more).
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
     bound from its bytes (~2 min more);
  8. resnet — ResNet50 v1.5 training at full width, in process, on
     NVML's energy counter: (a) the ``resnet50`` workload, ``python -m
     repro_torch.bench run --suite resnet50 --power auto --iters
     RESNET_ITERS``, its whole Space: the dp1 cells (global batch 16,
     32, 64 on full-width, full-depth ResNet50, bf16 params and compute,
     fp32 master weights and moments) must be ``ok``, ``nvml_energy``,
     ``model_scale=full`` with ``RESNET50_PARAMS`` parameters, a falling
     loss and finite images/Wh, and the dp2 and dp4 cells ``deferred``;
     one line per cell with images/s, ms/step, Wh/step, images/Wh, mean
     W, peak GB and the model-FLOP share (three times the forward
     convolutions' and head's operations over the step time against the
     card's dense bf16 peak); (b) a reduced fp32 ResNet (width 16, 64 x
     64 images) trains three AdamW steps on the card and on the CPU from
     the same weights and batches, with TF32 off for the card's
     convolutions (cuDNN takes TF32 for fp32 convolutions by default):
     losses agree at rtol 1e-4, and the params' largest difference is
     printed. ``--profile`` also traces one step at global batch 64: the
     device-busy share, the launches, and the device time in
     convolutions, BN and elementwise work, copies and casts, and the
     optimizer (~1 min more);
  9. families — the moe, ssm and hybrid decoder families, bf16 seeded
     random weights, NVML's energy counter, ``FAMILY_SLOTS`` slots:
     (a) full-width, full-depth granite-moe-3b-a800m (32 layers, 40
     experts top-8, Dh 64) serves ``FAMILY_REQUESTS_MOE`` of the serve
     requests through ``ServeEngine(cache="paged", sched="phased",
     prefix_cache=True)``: every request finishes its budget, the pool
     drains, the decode kernel launches once per attention layer and
     decode micro-step, the prefix index hits and the prefill kernel
     launches; (b) full-width, full-depth mamba2-1.3b (48 layers)
     serves ``FAMILY_REQUESTS`` requests, all arriving at once, paged
     and slotted: no attention kernel launches and the two layouts give
     equal streams (the same arithmetic); each prefill's length, SSD
     chunk (the reference's rule: the largest divisor of the length not
     above ``ssm_chunk``) and time are printed; (c) jamba-v0.1-52b at
     full width cut to one period, ``JAMBA_LAYERS`` layers (7 mamba, one
     attention layer without RoPE, MoE of 16 experts top-2 on every
     second layer; the 52 B model does not fit one card), the same
     requests on fp and int8 pools: one decode launch per micro-step
     each, the int8 path on the int8 pool. Each run prints decode
     tok/s, TTFT and TPOT, Wh/token, parameters, peak memory, launches
     and the card's name and power limit. The paged kernels are held to
     their plain versions (phase 1's gate) at the shapes these runs gave
     them: the first call of each shape (batch, heads, head dim, table
     width or prefix depth and suffix) on the inputs the run gave it,
     then on seeded random inputs at that shape over fp and int8 pools
     in fp32 and bf16 (granite-moe's decode and prefill at Dh 64,
     jamba's decode at 32/8 heads of 128); their largest bf16 errors
     join phase 1's in the JSON line. Then reduced fp32
     granite-moe, mamba2, jamba and llama4-maverick serve on the card
     and on the CPU from the same weights (LCP agreement >=
     ``STREAM_AGREEMENT`` each); three AdamW steps (bf16, fp32 master
     weights, full remat, lr 1e-6 so that the steps stay first-order,
     one repeated batch of ``FAMILY_TRAIN_BATCH`` x ``FAMILY_TRAIN_SEQ``
     tokens) of full-width, full-depth mamba2-1.3b and
     granite-moe-3b-a800m (the phase fails, naming the card's memory,
     if one does not fit: no depth is cut) give a falling loss, a
     finite aux and finite tokens/Wh, with ms/step, tokens/s, peak
     memory and the model-FLOP share on active parameters printed; and
     the reduced fp32 moe, ssm and hybrid configs take three AdamW steps
     on the card and on the CPU (losses and aux at rtol 1e-4, TF32 off).
     The two card-vs-CPU checks (``family_agreement``,
     ``family_train_agreement``) are the ones
     ``tests/test_torch_cuda.py`` runs. ``--profile`` also profiles five
     decode steps of each model's paged engine: device launches and
     device time a step, and the device-busy share.
  10. generate — fixed-batch ``BatchedServer.generate`` and the encdec
     and vlm families, bf16 seeded random weights, seeded random side
     inputs (the reference's launchers feed zeros, which would hide a
     wrong transpose), NVML's energy counter, ``GEN_BATCH`` prompts:
     (a) full-size whisper-small (12 + 12 layers, 1500 encoder frames)
     generates ``WHISPER_GEN`` tokens after ``WHISPER_PROMPT``; then
     three AdamW steps (lr 1e-6, as phase 9) at ``GEN_BATCH`` x
     ``WHISPER_TRAIN_SEQ`` text tokens; (b) llava-next-34b at full width
     cut to ``LLAVA_LAYERS`` of its 60 layers generates ``LLAVA_GEN``
     tokens after 2880 patches and ``LLAVA_TEXT`` text tokens: its
     prefill's score tensor (8 x 56 x 3072^2 = 4.23e9 elements) is past
     ``CHUNK_THRESHOLD``, so ``attention.sdpa_chunked_q`` must run once
     a layer (its call counter); then three AdamW steps at full width
     and ``LLAVA_TRAIN_LAYERS`` layers, ``LLAVA_TRAIN_BATCH`` x (2880 +
     192) rows. Each generate prints prefill ms, decode tok/s, Wh/token
     and peak GB (finite prefill logits over the vocabulary, in-vocab tokens), each training
     ms/step, tok/s, tokens/Wh and peak GB (falling loss); (c) reduced
     fp32 whisper and llava on the card and on the CPU from the same
     weights (TF32 off): ``generate`` streams agree at
     ``STREAM_AGREEMENT``, three AdamW steps' losses at rtol 1e-4, and
     ``sdpa_chunked_q`` equals full ``sdpa`` at 1e-5; (d) degradation:
     llama3.2-3b at full width cut to ``DEGRADE_LAYERS`` layers, served
     chunked on the paged pool: the ``decode_fault`` preset's slot
     fault fires, the streams' digest equals the fault-free run's,
     decode launches = micro-steps x layers (replays included) and the
     paged kernels pass phase 1's gate at the shapes the faulted run
     gave them; the ``overload`` preset sheds the newest queued requests
     and a 50 ms admission deadline the newest half, while the oldest
     request finishes its budget. 10d's paged launches join the main
     path's in the JSON line. ``--profile`` also profiles five decode
     steps of each ``generate``.
  11. harness — what launches no kernel (the reference trains through
     XLA), on NVML's energy counter: (a) the ``heatmap`` workload (the
     paper's Fig. 4), ``python -m repro_torch.bench run --suite heatmap
     --power auto``, its whole Space: the dp1 cells (global batch 8, 16,
     32 at sequence 64 on full-width, full-depth gpt-117m, bf16 compute
     and fp32 master weights, each measured window at least 0.5 s) must
     be ``ok``, ``nvml_energy``, ``model_scale=full`` with a falling
     loss and finite tokens/s, tokens/Wh and ``mfu``, and the dp2, dp4
     and dp8 cells ``deferred``, each with its sbatch file; the table,
     the rendered heatmap and one line per cell (tokens/s, ms, tokens/Wh,
     mean W, ``mfu``, peak GB) are printed; (b) the quickstart's
     pipeline at its ``--full-117m`` shape: ``QUICKSTART_DOCS`` synthetic
     OSCAR documents -> ``ByteFallbackTokenizer`` (vocabulary 50257) ->
     indexed dataset in a temporary directory -> ``ShardedLoader`` over
     ``lm_sample_fn`` -> ``train_loop`` with checkpointing, full gpt-117m,
     ``QUICKSTART_STEPS`` steps of ``QUICKSTART_BATCH`` x
     ``QUICKSTART_SEQ``: the loss must fall; tokens/s, tokens/Wh and the
     share of the loop's wall spent waiting on the loader are printed;
     (c) the power backends: whether the host exposes readable powercap
     (RAPL) zones, and their watts over a window of load if it does;
     ``FallbackPower(NvmlEnergy, NvmlPower)`` whose primary fails from
     read ``FALLBACK_FAIL_FROM`` on (a flaky wrapper), beside an
     unfaulted ``NvmlEnergy``, over ``FALLBACK_WINDOW_S`` of steady
     matmul load: its Wh must be within ``FALLBACK_TOL`` of the
     counter's, and its label must name the fallback. ``--profile``
     also traces one gb=32 heatmap step: the device-busy share, the
     launches and the device time by kind and range.
  12. dry run — (a) ``launch.dryrun.run_cells`` over every (arch x
     shape) cell of the reference on ``meta`` tensors, in
     ``DRYRUN_WORKERS`` processes: 33 cells ``ok``, the 7 ``long_500k``
     cells of quadratic attention skipped, 0 failed; the per-cell table
     (TFLOP, TB moved unfused, estimated peak GB, ``fits_hbm_80g``,
     bottleneck, roofline step time) and the wall are printed; (b) real
     steps on the card of ``REAL_STEP_CELLS`` (``dryrun.real_step``,
     seeded random weights, zero caches): the FLOPs
     ``FlopCounterMode`` counts on CUDA tensors must equal the meta
     count exactly and ``max_memory_allocated`` above the step's
     baseline must lie within ``PEAK_TOL`` of the meta estimate (the
     phase names both otherwise); the step time and its share of the
     roofline bound are printed, not gated. Phase 1 also holds the
     dense decode's grouped ``sdpa`` against its repeat one in bf16 at
     full llama3.2-3b and llava-next-34b head shapes
     (``check_grouped_decode``).
  13. parallel — data-parallel and pipeline-parallel ranks
     (``launch.mesh.spawn``) that share the one card over gloo (NCCL
     takes one card a rank; the script says so on a line): (a)
     ``llm_train``'s dp2 step on full-width gpt-800m, sequence
     ``PAR_SEQ``, global batch ``PAR_BATCH``, fp32 sync with ZeRO-1
     AdamW slices: per rank the losses of ``PAR_STEPS`` steps, ms a
     step, ``max_memory_allocated`` beside the reckoned memory, and a
     digest of the params, which must be equal across the ranks; (b) a
     reduced fp32 gpt-800m (TF32 off) at dp2 against dp1 on the card
     (losses at rtol 1e-4), its int8 sync against the same dp2 run on
     CPU ranks (error-feedback codes within one, in at most 0.1 % of
     entries), and the dp2 reduced ResNet step with BatchNorm synced
     over the ranks against its dp1 step (rtol 1e-4); (c)
     ``pipeline_gpt``'s pp4 forward at full gpt-117m width, 8
     microbatches of global batch ``PP_BATCH``, four ranks on the card,
     against the sequential forward of the same layers under phase 1's
     bf16 gate, with its ``bubble_fraction`` (3/11) and ms. Every number
     it prints carries ``PAR_NOTE`` and the card's name and power limit;
     a rank that fails fails the phase.

``--train`` runs phases 7 and 8 alone (no kernel is built: the training
paths launch none) and prints no result line. ``--families`` builds the
kernels and runs phase 9 alone, and ``--generate`` phase 10 alone; neither
prints a result line. ``--harness [--profile]`` runs phase 11 alone (no
kernel is built) and prints no result line.
``--dryrun`` runs the grouped-decode check and phase 12 alone (no
kernel is built) and prints no result line. ``--parallel`` runs phase
13 alone (no kernel is built: no kernel is on the data-parallel or
pipeline path) and prints no result line.
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

import contextlib
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
import types
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
#: phase 6's depth (``bench run --layers``): llama3.2-3b's first 12 of
#: its 28 layers at full width. The cells are host-bound, so their wall
#: scales with the layers' launches: at full depth phase 6 took 558-815
#: s of the script's 732-1087 s on the card machine's hosts, at 14
#: layers 311.5-376.3 s of 763.0-926.7 s (the latter with phase 13)
SERVE_LAYERS = 12
#: phase 7's measured steps per llm_train cell: two windows of two
#: ~0.9 s steps, many times the NVML energy counter's ~100 ms update
#: interval
TRAIN_ITERS = 4
#: AdamW's least HBM traffic per parameter: read the fp32 grad, m, v and
#: master, write m, v and master (fp32) and the bf16 param
ADAMW_BYTES_PER_PARAM = 4 * 4 + 3 * 4 + 2
#: phase 7's and 8's profiler ranges (train/step.py, grad_sync.py,
#: optimizer.py)
TRAIN_RANGES = ("forward_backward", "grad_sync", "optimizer")
#: phase 8's measured steps per resnet50 cell: two windows of ten
#: ~75 ms steps, each window several times the NVML energy counter's
#: ~100 ms update interval
RESNET_ITERS = 20
#: full-width ResNet50's parameters (the reference's init, counted)
RESNET50_PARAMS = 25_557_032
#: phase 9: the families' reduced configs (card-vs-CPU checks); serve
#: slots and length, requests per run (granite-moe's run: enough to reach admission
#: waves after the shared system prompt registers), jamba's depth (one
#: period of its eight-layer pattern: the full 52 B model does not fit
#: one card) and the training batch
FAMILY_ARCHS = ("granite-moe-3b-a800m", "mamba2-1.3b", "jamba-v0.1-52b",
                "llama4-maverick-400b-a17b")
FAMILY_SLOTS = 8
FAMILY_MAX_LEN = 1024
FAMILY_REQUESTS = 8
FAMILY_REQUESTS_MOE = 12
JAMBA_LAYERS = 8
FAMILY_TRAIN_BATCH = 8
FAMILY_TRAIN_SEQ = 512
#: phase 10: fixed-batch generate of the encdec and vlm families. The
#: batch; whisper-small's prompt and new tokens, and its training text
#: (448 tokens: whisper's published decoder context); llava-next-34b's
#: text after its 2880 patches, new tokens, serving depth (16 of 60
#: layers: full depth is 68.8 GB of bf16 weights, leaving ~11 GB for a
#: batch-8 prefill of 3072 tokens) and training depth and batch
GEN_BATCH = 8
WHISPER_PROMPT, WHISPER_GEN, WHISPER_TRAIN_SEQ = 64, 64, 448
LLAVA_TEXT, LLAVA_GEN, LLAVA_LAYERS = 192, 32, 16
LLAVA_TRAIN_LAYERS, LLAVA_TRAIN_BATCH = 2, 2
#: 10d: llama3.2-3b at full width, cut to this depth, served chunked on
#: the paged pool with a slot fault, an overload window and deadlines
DEGRADE_LAYERS = 4
DEGRADE_REQUESTS = 16
#: phase 11: the quickstart pipeline at its --full-117m shape (documents,
#: global batch, sequence) and steps (~0.1 s a step, host-bound), and the
#: fallback probe's window of steady load and the read from which its
#: primary fails (reads every FALLBACK_INTERVAL_MS)
QUICKSTART_DOCS, QUICKSTART_BATCH, QUICKSTART_SEQ = 2000, 8, 256
QUICKSTART_STEPS = 300
FALLBACK_WINDOW_S, FALLBACK_INTERVAL_MS, FALLBACK_FAIL_FROM = 10.0, 100, 20
FALLBACK_TOL = 0.05


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


def decode_case(rng, lengths, dtype, dev, nb=64, width=64, int8=False,
                h=H, kh=KH, dh=DH):
    """Decode inputs whose tables are the first ``nb`` columns of a
    ``(B, width)`` table, as the engine slices its device tables to the
    power-of-two bucket of the longest live slot, at ``h`` query and
    ``kh`` KV heads of ``dh`` (llama3.2-3b's by default). With ``int8``
    the pools are int8 codes and the returned kwargs carry their
    (n_blocks, Kh) scales."""
    from repro_torch.bench.workloads.kernels import quantize
    b = len(lengths)
    n_blocks = 1 + b * nb
    perm = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((b, width), np.int32)         # unowned -> trash 0
    for i, ln in enumerate(lengths):
        need = -(-int(ln) // BS)
        tables[i, :need] = perm[i * nb:i * nb + need]
    t = lambda *s: torch.randn(*s, device=dev, dtype=torch.float32).to(dtype)
    kp, vp = t(n_blocks, BS, kh, dh), t(n_blocks, BS, kh, dh)
    kw = {}
    if int8:
        kp, kw["k_scale"] = quantize(kp.float())
        vp, kw["v_scale"] = quantize(vp.float())
    return (t(b, h, dh), kp, vp, torch.from_numpy(tables).to(dev)[:, :nb],
            torch.from_numpy(np.asarray(lengths, np.int32)).to(dev)), kw


def prefill_case(rng, npre, sq, dtype, dev, int8=False, b=B, h=H, kh=KH,
                 dh=DH):
    """Prefix-hit prefill inputs for ``b`` rows at ``h`` query and ``kh``
    KV heads of ``dh`` (llama3.2-3b's by default); the last row is a
    batch pad row whose table names only the trash block 0, as the
    engine pads its groups. With ``int8`` the pools are int8 codes and
    the kwargs carry their (n_blocks, Kh) scales, quantized as the
    ``kernels`` workload does."""
    from repro_torch.bench.workloads.kernels import quantize
    n_blocks = 1 + b * npre + 4
    tables = rng.permutation(np.arange(1, n_blocks))[:b * npre]
    tables = tables.reshape(b, npre).astype(np.int32)
    tables[-1] = 0
    t = lambda *s: torch.randn(*s, device=dev, dtype=torch.float32).to(dtype)
    kp, vp = t(n_blocks, BS, kh, dh), t(n_blocks, BS, kh, dh)
    kw = {}
    if int8:
        kp, kw["k_scale"] = quantize(kp.float())
        vp, kw["v_scale"] = quantize(vp.float())
    return (t(b, sq, h, dh), t(b, sq, kh, dh), t(b, sq, kh, dh), kp, vp,
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
    check_grouped_decode(dev)
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
    engine = ServeEngine(c, params, n_slots=8, max_len=1024, cache="paged",
                         block_size=16, prefix_cache=True, device=dev,
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
                             cache="paged", block_size=16,
                             n_blocks=INT8_POOL_BLOCKS,
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
                          cache="paged", block_size=16, prefix_cache=True,
                          device=where, **kw)
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
    smoke preset narrowed by ``points``, the model cut to
    ``SERVE_LAYERS`` layers); returns its records."""
    from repro_torch.bench import cli
    from repro_torch.bench.records import load_records
    t0 = time.perf_counter()
    rc = cli.main(["run", "--suite", name, "--smoke", "--points", points,
                   "--device", "cuda", "--power", "auto", "--layers",
                   str(SERVE_LAYERS), "--out", out, "--quiet"])
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
        f"model_scale={m['model_scale']} n_layers={m['n_layers']} "
        f"n_params={m['n_params']}")


def check_workload_record(name: str, r) -> None:
    """The record's depth, and the kernels its measured run must (and
    must not) have launched, by its cell."""
    m, pt = r.metrics, r.point
    assert r.status == "ok", (name, pt, r.error)
    assert r.power_source == "nvml_energy", (name, pt, r.power_source)
    assert m["model_scale"] == "full_width", (name, pt)
    n_layers = m["n_layers"]
    assert n_layers == SERVE_LAYERS, (name, pt, n_layers)
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


def phase_workloads(dev, profile: bool = False) -> dict:
    """The serve and serve_slo workloads through the port's bench CLI at
    full width, ``SERVE_LAYERS`` deep (see the module docstring);
    returns the launches counted over the phase, per kernel."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import paged_decode_attention
    from repro_torch.kernels.prefill_attention import paged_prefill_attention
    t_phase = time.perf_counter()
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
            check_workload_record(name, r)
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
    log(f"[wall] phase 6 {time.perf_counter() - t_phase:.1f} s "
        f"({SERVE_LAYERS} layers)")
    if profile:
        profile_main_cell(dev)
    return counts


def profile_main_cell(dev) -> None:
    """The serve workload's main-path cell (its engine and requests)
    under ``torch.profiler``: its device-busy share beside its wall."""
    from repro_torch.bench.context import RunContext
    from repro_torch.bench.workloads import serve as wl
    from repro_torch.serve.requests import poisson_requests
    ctx = RunContext(device=dev, smoke=True, layers=SERVE_LAYERS)
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


def profile_step(tag: str, one_step, kind_of, kinds: tuple) -> dict:
    """``one_step()`` once under ``torch.profiler`` (the caller warms it
    up first): its wall, the device-busy ms and launches, the device ms
    by kind (``kind_of(kernel name)`` in ``kinds``; kernels launched
    inside the ``optimizer`` range count as ``optimizer``) and by range
    (``TRAIN_RANGES``); logs the 15 kernels that took the most device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in TRAIN_RANGES]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_kind = dict.fromkeys(kinds, 0.0)
    for e in kernels:
        by_kind[kind_of(e.name)] += e.time_range.elapsed_us() / 1e3
    ranges = {}
    for name in TRAIN_RANGES:
        ks = [k for e in events if e.name == name
              and e.device_type == DeviceType.CPU
              for k in _subtree_kernels(e)]
        ranges[name] = sum(k.duration for k in ks) / 1e3
        if name == "optimizer":
            for k in ks:                      # optimizer counts apart
                by_kind[kind_of(k.name)] -= k.duration / 1e3
    by_kind["optimizer"] = ranges["optimizer"]
    rows = prof.key_averages()
    rows = sorted((e for e in rows if e.device_type == DeviceType.CUDA
                   and e.key not in TRAIN_RANGES),
                  key=lambda e: -e.self_device_time_total)
    for e in rows[:15]:
        log(f"[{tag}] {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:6d}x  {e.key[:100]}")
    return {"wall": wall, "busy": busy, "launches": len(kernels),
            "by_kind": by_kind, "ranges": ranges}


def profile_train_step(dev) -> None:
    """One full-width gpt-800m step at global batch 64 (the llm_train
    fp32 cell: 4 microbatches, overlapped bucket sync) under
    ``torch.profiler``: the device-busy share of its wall, and its
    device time by kind, beside the optimizer's bound from its bytes."""
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
    state = [p, o, gs.init_sync_state(p, sync)]
    gb, seq = 64, 128
    toks = torch.from_numpy(synthetic_tokens(gb, seq, c.vocab)[:, :seq])
    batch = {"tokens": toks.to(dev), "labels": torch.roll(toks, -1, 1)
             .to(dev)}

    def one():
        state[:] = step(*state, batch)[:3]

    for _ in range(2):                      # warm: allocator, handles
        one()
    r = profile_step("profile train", one, _kernel_kind,
                     ("gemms", "elementwise", "copies"))
    wall, busy, by_kind = r["wall"], r["busy"], r["by_kind"]
    opt_bound = ADAMW_BYTES_PER_PARAM * n_params / HBM_BYTES_PER_S * 1e3
    log(f"[profile train] gpt-800m gb={gb} seq={seq} k=4 fp32 sync: wall "
        f"{wall * 1e3:.2f} ms (profiled), device busy {busy:.2f} ms = "
        f"{busy / 1e3 / wall:.4f} of wall, {r['launches']} device events; "
        f"model-FLOP share over the profiled wall "
        f"{model_flop_share(n_params, gb * seq, wall):.4f}")
    log("[profile train] device ms by kind: " + ", ".join(
        f"{k} {v:.2f} ({v / busy:.3f})" for k, v in by_kind.items()))
    log("[profile train] device ms by range: " + ", ".join(
        f"{k} {v:.2f}" for k, v in r["ranges"].items())
        + f"; optimizer bound from its bytes "
          f"({ADAMW_BYTES_PER_PARAM} B x {n_params / 1e6:.1f}M params) "
          f"{opt_bound:.2f} ms")
    del p, o, state
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 8: ResNet50 training
# ---------------------------------------------------------------------------


def phase_resnet(dev, profile: bool = False) -> None:
    """ResNet50 training at full width (see the module docstring)."""
    from repro_torch.bench import cli
    from repro_torch.bench.records import load_records
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        rc = cli.main(["run", "--suite", "resnet50", "--device", "cuda",
                       "--power", "auto", "--iters", str(RESNET_ITERS),
                       "--out", out, "--quiet"])
        records = load_records(f"{out}/resnet50/results.json")
    log(f"[resnet] resnet50 Space: rc {rc}, {len(records)} records in "
        f"{time.perf_counter() - t_phase:.1f} s")
    assert rc == 0, rc
    measured = [r for r in records if r.point["placement"] == "dp1"]
    deferred = [r for r in records if r.point["placement"] != "dp1"]
    assert sorted(r.point["global_batch"] for r in measured) == \
        [16, 32, 64], records
    for r in measured:
        m, gb = r.metrics, r.point["global_batch"]
        log(f"[resnet] resnet50 gb={gb} dp1: images_per_s="
            f"{m.get('images_per_s', 0):.2f} ms_per_step="
            f"{m.get('ms_per_step', 0):.3f} energy_wh_per_step="
            f"{m.get('energy_wh_per_step', 0):.6e} images_per_wh="
            f"{m.get('images_per_wh', 0):.1f} mean_w="
            f"{m.get('energy_wh_per_step', 0) * 3600 / m['seconds']:.1f} "
            f"peak_mem_gb={m.get('peak_mem_gb', 0):.2f} model_flop_share="
            f"{m.get('model_flop_share', 0):.4f} loss "
            f"{m.get('loss_first', 0):.4f} -> {m.get('loss_last', 0):.4f} "
            f"rel_spread={r.noise['rel_std']} power_source={r.power_source} "
            f"model_scale={m.get('model_scale')} "
            f"n_params={m.get('n_params')}")
    for r in measured:
        m = r.metrics
        assert r.status == "ok", (r.point, r.error)
        assert r.power_source == "nvml_energy", (r.point, r.power_source)
        assert m["model_scale"] == "full", r.point
        assert m["n_params"] == RESNET50_PARAMS, (r.point, m["n_params"])
        assert m["loss_last"] < m["loss_first"], (r.point, m)
        assert math.isfinite(m["images_per_wh"]) and m["images_per_wh"] > 0
    assert sorted((r.point["placement"], r.point["global_batch"])
                  for r in deferred) == [(plc, gb) for plc in ("dp2", "dp4")
                                         for gb in (16, 32, 64)], records
    assert all(r.status == "deferred" for r in deferred), deferred
    log(f"[resnet] dp2 and dp4: {len(deferred)} records deferred "
        f"({deferred[0].error})")
    del records
    gc.collect()
    torch.cuda.empty_cache()
    resnet_agreement(dev)
    log(f"[wall] phase 8 {time.perf_counter() - t_phase:.1f} s")
    if profile:
        profile_resnet_step(dev)


def resnet_agreement(dev) -> None:
    """Reduced fp32 ResNet (width 16, 64 x 64 images), three AdamW steps
    from the same weights and batches on the card and on the CPU, TF32
    off for the card's convolutions (cuDNN takes TF32 for fp32
    convolutions by default): losses at rtol 1e-4."""
    from repro_torch.configs.resnet50 import CONFIG
    from repro_torch.core import tree
    from repro_torch.data.synthetic import synthetic_images
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import init_train_state, make_resnet_train_step
    c = CONFIG.reduced(img_size=64, width=16, dtype="float32",
                       param_dtype="float32")
    oc = OptConfig(warmup=2, total_steps=1000)
    step = make_resnet_train_step(c, oc)
    cpu = torch.device("cpu")
    state = {cpu: init_train_state(c, oc, torch.Generator().manual_seed(0),
                                   cpu)}
    state[dev] = tree.tree_map(lambda t: t.to(dev), state[cpu])
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    losses = {cpu: [], dev: []}
    try:
        for i in range(3):
            imgs, labels = synthetic_images(8, c.img_size, c.n_classes,
                                            seed=i)
            for d in (cpu, dev):
                batch = {"images": torch.from_numpy(imgs).to(d),
                         "labels": torch.from_numpy(labels).to(d)}
                p, o = state[d]
                p, o, m = step(p, o, batch)
                losses[d].append(float(m["loss"]))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    diffs = [(a.cpu() - b).abs() for a, b in
             zip(tree.leaves(state[dev][0]), tree.leaves(state[cpu][0]))]
    worst = max(d.max().item() for d in diffs)
    log(f"[resnet] reduced fp32 {c.name} (TF32 off), 3 AdamW steps: card "
        f"losses {losses[dev]}, cpu {losses[cpu]}; params max |diff| "
        f"{worst:.3e}")
    np.testing.assert_allclose(losses[dev], losses[cpu], rtol=1e-4)


def _resnet_kernel_kind(name: str) -> str:
    n = name.lower()
    if any(k in n for k in ("bn_", "batch_norm", "batchnorm", "welford")):
        return "bn_elementwise"
    if n.startswith(("memcpy", "memset")) or any(
            k in n for k in ("copy_kernel", "nchwtonhwc", "nhwctonchw")):
        return "copies"
    if any(k in n for k in ("conv", "cudnn", "xmma", "dgrad", "wgrad",
                            "fprop", "implicit", "gemm", "nvjet",
                            "cutlass")):
        return "convs"
    return "bn_elementwise"


def profile_resnet_step(dev) -> None:
    """One full-width ResNet50 step at global batch 64 (the resnet50
    cell) under ``torch.profiler``: the device-busy share of its wall,
    its launches, and its device time in convolutions (cuDNN, with their
    layout transforms counted as copies), BN and elementwise work,
    copies and casts (the per-convolution weight copies among them) and
    the optimizer, beside the optimizer's bound from its bytes."""
    from repro_torch.configs.resnet50 import CONFIG as c
    from repro_torch.core import tree
    from repro_torch.data.synthetic import synthetic_images
    from repro_torch.models import resnet
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import init_train_state, make_resnet_train_step
    oc = OptConfig(warmup=2, total_steps=1000)
    p, o = init_train_state(c, oc, torch.Generator(device=dev).manual_seed(0),
                            dev)
    n_params = sum(t.numel() for t in tree.leaves(p))
    step = make_resnet_train_step(c, oc)
    gb = 64
    imgs, labels = synthetic_images(gb, c.img_size, c.n_classes)
    batch = {"images": torch.from_numpy(imgs).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}
    state = [p, o]

    def one():
        state[:] = step(*state, batch)[:2]

    for _ in range(2):                      # warm: allocator, cuDNN plans
        one()
    r = profile_step("profile resnet", one, _resnet_kernel_kind,
                     ("convs", "bn_elementwise", "copies"))
    wall, busy, by_kind = r["wall"], r["busy"], r["by_kind"]
    opt_bound = ADAMW_BYTES_PER_PARAM * n_params / HBM_BYTES_PER_S * 1e3
    share = 3 * resnet.forward_flops(c) * gb / wall / PEAK_FLOPS[
        torch.bfloat16]
    log(f"[profile resnet] resnet50 gb={gb}: wall {wall * 1e3:.2f} ms "
        f"(profiled), device busy {busy:.2f} ms = {busy / 1e3 / wall:.4f} "
        f"of wall, {r['launches']} device launches; model-FLOP share over "
        f"the profiled wall {share:.4f}")
    log("[profile resnet] device ms by kind: " + ", ".join(
        f"{k} {v:.2f} ({v / busy:.3f})" for k, v in by_kind.items()))
    log("[profile resnet] device ms by range: " + ", ".join(
        f"{k} {v:.2f}" for k, v in r["ranges"].items())
        + f"; optimizer bound from its bytes "
          f"({ADAMW_BYTES_PER_PARAM} B x {n_params / 1e6:.2f}M params) "
          f"{opt_bound:.3f} ms")
    del p, o, state
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


# ---------------------------------------------------------------------------
# Phase 9: the moe, ssm and hybrid families
# ---------------------------------------------------------------------------


def family_model(dev, arch: str, n_layers=None):
    """Full-width ``arch`` (depth cut to ``n_layers`` when given) with
    seeded random bf16 weights on the card; logs its size beside the
    card."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    full = get_config(arch)
    c = full if n_layers is None else dataclasses.replace(full,
                                                         n_layers=n_layers)
    t0 = time.perf_counter()
    params = lm.init(c, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    cut = (f" (cut from {full.n_layers} layers: {full.param_count():,} "
           f"params at full depth)" if c.n_layers != full.n_layers else "")
    log(f"[families] {c.name}: {c.family}, n_layers={c.n_layers}{cut}, "
        f"d_model {c.d_model}, {n:,} params in the tree "
        f"({c.param_count():,} by the config's count, "
        f"{c.active_param_count():,} active a token), "
        f"{nbytes / 1e9:.2f} GB ({c.param_dtype}), initialised in "
        f"{time.perf_counter() - t0:.1f} s; card {card_line()}")
    return c, params


def family_requests(vocab: int, n: int, at_once: bool):
    """``n`` of ``serve_requests``, all arriving at once when
    ``at_once`` (a schedule that does not depend on the card's speed)."""
    reqs = serve_requests(vocab, n=n)
    if at_once:
        reqs = [dataclasses.replace(r, arrival_s=0.0) for r in reqs]
    return reqs


def profile_decode_step(engine, tag: str, steps: int = 5) -> None:
    """``steps`` decode steps of the engine's model over all its slots
    (the pool as the last run left it: every table column on the trash
    block, state rows as they are) under ``torch.profiler``: device
    launches and device time a step, and the device-busy share of the
    steps' wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import lm
    dev = engine.device
    tok = torch.zeros((engine.n_slots, 1), dtype=torch.int64, device=dev)
    pos = torch.full((engine.n_slots,), 7, dtype=torch.int32, device=dev)
    kw = {}
    if engine._paged is not None:
        kw = dict(block_tables=engine._paged.device_tables(), n_kv_blocks=1)

    def run(n):
        with torch.no_grad():
            for _ in range(n):
                lm.decode_step(engine.c, engine.params, tok, engine.caches,
                               pos, **kw)
        torch.cuda.synchronize()

    run(3)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(steps)
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    log(f"[profile {tag}] decode step ({engine.n_slots} slots): "
        f"{launches / steps:.0f} device launches, {busy_us / steps / 1e3:.3f} "
        f"ms device time, {wall / steps * 1e3:.3f} ms wall a step (profiled); "
        f"device busy {busy_us / 1e6 / wall:.3f} of the wall; card "
        f"{card_line()}")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:8]:
        log(f"[profile {tag}] {e.self_device_time_total / steps / 1e3:8.3f} "
            f"ms a step {e.count // steps:5d}x  {e.key[:90]}")


@contextlib.contextmanager
def kept_paged_calls():
    """Within the block every call the model makes to
    ``ops.paged_decode_attention`` or ``ops.paged_prefill_attention``
    goes through as before, and the first call of each signature (op,
    input shapes, dtype, window, pool kind) is kept with its inputs
    cloned (the pools are written in place afterwards). Yields the dict
    of kept calls for ``check_paged_calls``. The wrapper adds a tuple of
    shapes and a dict lookup to each call on the host."""
    from repro_torch.kernels import ops
    names = ("paged_decode_attention", "paged_prefill_attention")
    orig = {n: getattr(ops, n) for n in names}
    kept = {}

    def wrap(name):
        def call(*args, window=None, k_scale=None, v_scale=None):
            key = (name, tuple(tuple(a.shape) for a in args), args[0].dtype,
                   window, k_scale is not None)
            if key not in kept:
                kw = {"window": window}
                if k_scale is not None:
                    kw.update(k_scale=k_scale.clone(),
                              v_scale=v_scale.clone())
                kept[key] = ([a.clone() for a in args], kw)
            return orig[name](*args, window=window, k_scale=k_scale,
                              v_scale=v_scale)
        return call

    for n in names:
        setattr(ops, n, wrap(n))
    try:
        yield kept
    finally:
        for n, fn in orig.items():
            setattr(ops, n, fn)


def check_paged_calls(tag: str, kept: dict, worst: dict, dev) -> None:
    """Phase 1's gate (``check_kernel``) on the paged kernels at the
    shapes a phase-9 serve run gave them: each kept call on the inputs
    the run gave it, then seeded random inputs at its batch, heads, head
    dim, table width (decode: columns of a ``FAMILY_MAX_LEN`` table) or
    prefix depth and suffix (prefill), over fp and int8 pools in fp32 and
    bf16."""
    from repro_torch.bench.workloads.kernels import plain_fp32
    from repro_torch.kernels import ops, ref
    plain = {"paged_decode_attention": ref.paged_decode_attention_ref,
             "paged_prefill_attention": ref.paged_prefill_attention_ref}
    rng = np.random.default_rng(9)
    shapes = {}
    for (name, shp, dtype, window, int8), (args, kw) in kept.items():
        decode = name == "paged_decode_attention"
        pool, table = (shp[1], shp[3]) if decode else (shp[3], shp[5])
        check_kernel(f"{name}[int8]" if int8 else name, worst,
                     getattr(ops, name)(*args, **kw),
                     plain_fp32(plain[name], *args, **kw), dtype,
                     f"{tag} serve inputs q {shp[0]} pool {pool} table "
                     f"{table} window={window}")
        if decode:
            (b, h, dh), kh = shp[0], shp[1][2]
            shapes[(name, b, h, kh, dh, table[1], window)] = None
        else:
            (b, sq, h, dh), kh = shp[0], shp[1][2]
            shapes[(name, b, h, kh, dh, table[1], sq, window)] = None
    for key in shapes:
        name, b, h, kh, dh, depth = key[:6]
        window = key[-1]
        for dtype in (torch.float32, torch.bfloat16):
            for int8 in (False, True):
                if name == "paged_decode_attention":
                    lengths = rng.integers(1, depth * BS + 1, size=b)
                    lengths[0], lengths[-1] = 1, depth * BS
                    args, kw = decode_case(
                        rng, lengths, dtype, dev, nb=depth,
                        width=FAMILY_MAX_LEN // BS, int8=int8, h=h, kh=kh,
                        dh=dh)
                    what = f"lengths={lengths.tolist()}"
                else:
                    args, kw = prefill_case(rng, depth, key[6], dtype, dev,
                                            int8, b=b, h=h, kh=kh, dh=dh)
                    what = f"sq={key[6]}"
                check_kernel(
                    f"{name}[int8]" if int8 else name, worst,
                    getattr(ops, name)(*args, window=window, **kw),
                    plain_fp32(plain[name], *args, window=window, **kw),
                    dtype, f"{tag} B={b} H={h} Kh={kh} Dh={dh} "
                    f"{'nb' if len(key) == 7 else 'npre'}={depth} "
                    f"window={window} {what}")


def family_serve(dev, tag: str, c, params, reqs, profile: bool = False,
                 **engine_kw) -> dict:
    """One measured serve run of a phase-9 model (after a warmup on the
    first two requests): every request finishes its budget, a paged pool
    drains, and the paged decode kernel launches once per attention
    layer and decode micro-step (none on a slotted cache). Logs the
    serve metrics, parameters, peak memory, launches and, for stacks
    with mamba layers, every prefill's length, SSD chunk and time.
    Returns the launch counts, prefix hits, micro-steps, streams and the
    paged kernels' calls kept by ``kept_paged_calls``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import paged_decode_attention
    from repro_torch.kernels.prefill_attention import paged_prefill_attention
    from repro_torch.models.blocks import attn_layers
    from repro_torch.models.ssm import ssd_chunk_size
    from repro_torch.power.methods import NvmlEnergy
    from repro_torch.serve.engine import ServeEngine

    power = NvmlEnergy(dev.index or 0)
    engine = ServeEngine(c, params, n_slots=FAMILY_SLOTS,
                         max_len=FAMILY_MAX_LEN,
                         block_size=16, device=dev, power_methods=[power],
                         **engine_kw)
    t0 = time.perf_counter()
    engine.warmup(requests=reqs[:2],
                  repeat=2 if engine_kw.get("prefix_cache") else 1)
    log(f"[{tag}] warmup {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with kept_paged_calls() as kept:
        out = engine.serve(reqs, policy="continuous")
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts())
    counts[DECODE_INT8] = paged_decode_attention.launches_int8
    counts[INT8] = paged_prefill_attention.launches_int8
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hits = engine.prefix_stats["hit_requests"]

    assert len(out.results) == len(reqs)
    for r, req in zip(sorted(out.results, key=lambda r: r.rid), reqs):
        assert r.finish_reason == "length", (tag, r.rid, r.finish_reason)
        assert len(r.tokens) == req.max_new_tokens, (tag, r.rid)
        assert all(0 <= t < c.vocab for t in r.tokens), (tag, r.rid)
    micro = sum(st.n_steps for st in out.steps if st.kind == "decode")
    n_attn = attn_layers(c)
    paged = engine._paged
    if paged is not None:
        engine.reset_prefix_cache()
        assert all(len(o) == 0 for o in paged._owned), tag
        assert paged.free_blocks == paged.n_blocks - 1, tag
        assert counts["paged_decode_attention"] == micro * n_attn, (
            tag, counts, micro, n_attn)
        int8 = engine_kw.get("kv_dtype") == "int8"
        assert counts[DECODE_INT8] == (counts["paged_decode_attention"]
                                       if int8 else 0), (tag, counts)
    else:
        assert counts["paged_decode_attention"] == 0, (tag, counts)
    s = out.summary
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[{tag}] {c.name} n_layers={c.n_layers} ({n_attn} attention), "
        f"{s.n_requests} requests, "
        f"{sum(r.prompt_len for r in out.results)} prompt tokens, "
        f"{s.n_tokens} generated in {wall:.2f} s; decode micro-steps "
        f"{micro}, launches {counts} ({counts['paged_decode_attention']} "
        f"decode = {micro} x {n_attn}), prefix hits {hits}, prefill "
        f"windows {sum(1 for st in out.steps if st.kind == 'prefill')}; "
        f"params {n_params:,}, peak memory {peak_gb:.2f} GB; card "
        f"{card_line()}")
    log_serve(tag, out, wall, power)
    if profile:
        profile_decode_step(engine, tag)
    if c.family in ("ssm", "hybrid"):
        lens = {r.rid: r.prompt_len for r in out.results}
        for st in out.steps:
            if st.kind == "prefill":
                n = lens[st.rids[0]]
                log(f"[{tag}] prefill rids {list(st.rids)}: length {n}, SSD "
                    f"chunk {ssd_chunk_size(c, n)} ({n // ssd_chunk_size(c, n)}"
                    f" sequential chunk steps a mamba layer), "
                    f"{(st.t1 - st.t0) * 1e3:.1f} ms")
    power.close()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"counts": counts, "hits": hits, "micro": micro, "kept": kept,
            "streams": {r.rid: list(r.tokens) for r in out.results}}


def phase_families_serve(dev, profile: bool = False) -> dict:
    """Phase 9's serve runs (see the module docstring); ``profile``
    also profiles a decode step of each model's paged engine. Returns
    the largest bf16 error of each paged kernel at the runs' shapes."""
    worst = dict.fromkeys(("paged_decode_attention", DECODE_INT8,
                           "paged_prefill_attention", INT8), 0.0)
    c, params = family_model(dev, "granite-moe-3b-a800m")
    reqs = family_requests(c.vocab, FAMILY_REQUESTS_MOE, at_once=False)
    run = family_serve(dev, "moe", c, params, reqs, profile=profile,
                       cache="paged", sched="phased", prefix_cache=True)
    assert run["hits"] > 0, run["hits"]
    assert run["counts"]["paged_prefill_attention"] > 0, run["counts"]
    assert {k[0] for k in run["kept"]} == {"paged_decode_attention",
                                           "paged_prefill_attention"}
    check_paged_calls("moe", run["kept"], worst, dev)
    del params, run
    torch.cuda.empty_cache()

    c, params = family_model(dev, "mamba2-1.3b")
    reqs = family_requests(c.vocab, FAMILY_REQUESTS, at_once=True)
    runs = {cache: family_serve(dev, f"ssm {cache}", c, params, reqs,
                                profile=profile and cache == "paged",
                                cache=cache)
            for cache in ("paged", "slotted")}
    for run in runs.values():
        assert sum(run["counts"].values()) == 0, run["counts"]
        assert not run["kept"], list(run["kept"])
    assert runs["paged"]["streams"] == runs["slotted"]["streams"]
    log("[ssm] paged and slotted streams equal")
    del params
    torch.cuda.empty_cache()

    c, params = family_model(dev, "jamba-v0.1-52b", n_layers=JAMBA_LAYERS)
    reqs = family_requests(c.vocab, FAMILY_REQUESTS, at_once=True)
    runs = {kv: family_serve(dev, f"hybrid {kv}", c, params, reqs,
                             profile=profile and kv == "fp32",
                             cache="paged", kv_dtype=kv)
            for kv in ("fp32", "int8")}
    log(f"[hybrid] int8 vs bf16 pool stream agreement (recorded, not "
        f"gated) {agreement(runs['fp32']['streams'], runs['int8']['streams']):.4f}")
    kept = {**runs["fp32"]["kept"], **runs["int8"]["kept"]}
    assert {(k[0], k[4]) for k in kept} == {
        ("paged_decode_attention", False), ("paged_decode_attention", True)}
    check_paged_calls("hybrid", kept, worst, dev)
    del params, runs, kept
    gc.collect()
    torch.cuda.empty_cache()
    return worst


def family_agreement(arch: str, dev, cache: str = "paged") -> float:
    """Reduced fp32 ``arch``, the same weights and requests, served on the
    card ``dev`` (kernels) and on the CPU (plain versions) through a
    ``cache`` engine, the prefix cache on where the family and the cache
    allow it: every request finishes its budget, the paged decode kernel
    launches once per attention layer and micro-step on a paged cache
    (never on a slotted one), and the streams' LCP agreement is at least
    ``STREAM_AGREEMENT``. Returns the agreement. Phase 9 and
    ``tests/test_torch_cuda.py`` both run it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.models.blocks import attn_layers
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.requests import Request

    c = get_config(arch).reduced(dtype="float32", param_dtype="float32")
    prefix = cache == "paged" and c.family not in ("ssm", "hybrid")
    cpu_params = lm.init(c, torch.Generator().manual_seed(1), "cpu")
    params = {"cpu": cpu_params, "cuda": _to(cpu_params, dev)}
    rng = np.random.default_rng(1)
    shared = rng.integers(0, c.vocab, size=32)
    reqs = [Request(rid=i, prompt=np.concatenate(
                [shared, rng.integers(0, c.vocab, size=int(
                    rng.integers(3, 20)))]).astype(np.int32)
                if i % 2 == 0 else rng.integers(0, c.vocab, size=int(
                    rng.integers(8, 40))).astype(np.int32),
                max_new_tokens=int(rng.integers(8, 24)))
            for i in range(8)]
    streams = {}
    for where in ("cpu", "cuda"):
        eng = ServeEngine(c, params[where], n_slots=4, max_len=128,
                          cache=cache, block_size=16, prefix_cache=prefix,
                          device=dev if where == "cuda" else where)
        ops.reset_launch_counts()
        out = eng.serve(reqs)
        assert all(r.n_tokens == q.max_new_tokens for r, q in zip(
            sorted(out.results, key=lambda r: r.rid), reqs)), arch
        streams[where] = {r.rid: list(r.tokens) for r in out.results}
    micro = sum(st.n_steps for st in out.steps if st.kind == "decode")
    counts = ops.launch_counts()
    want = micro * attn_layers(c) if cache == "paged" else 0
    assert counts["paged_decode_attention"] == want, (arch, counts, micro)
    agree = agreement(streams["cpu"], streams["cuda"])
    log(f"[families] reduced fp32 {c.name}, {cache} cache: card vs cpu "
        f"stream agreement {agree:.4f} over {len(reqs)} requests; card "
        f"launches {counts}")
    assert agree >= STREAM_AGREEMENT, (arch, agree)
    return agree


def card_memory() -> str:
    """What the caching allocator holds (live tensors, and reserved
    segments) and what CUDA reports free of the card's total."""
    free, total = torch.cuda.mem_get_info()
    return (f"allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB, "
            f"reserved {torch.cuda.memory_reserved() / 1e9:.2f} GB, free "
            f"{free / 1e9:.2f} of {total / 1e9:.2f} GB")


def side_inputs(c, b: int, seed: int, dev) -> dict:
    """A vlm's patch embeddings or an encdec's encoder frames for ``b``
    rows, seeded standard normal in the model's dtype on ``dev`` (drawn
    on the CPU, so the card and the CPU get the same values), keyed as
    ``lm`` takes them; nothing for the other families. Random, where the
    reference's launchers feed zeros, which would hide a wrong
    transpose."""
    from repro_torch.models.common import dtype_of
    key, n = {"vlm": ("patch_embeds", c.n_patches),
              "encdec": ("enc_frames", c.enc_seq)}.get(c.family, (None, 0))
    if key is None:
        return {}
    x = torch.randn((b, n, c.d_model), generator=torch.Generator()
                    .manual_seed(seed))
    return {key: x.to(dev, dtype_of(c))}


def family_train(dev, arch: str, n_layers=None,
                 batch: int = FAMILY_TRAIN_BATCH,
                 seq: int = FAMILY_TRAIN_SEQ) -> None:
    """Three AdamW steps (bf16 compute, fp32 master weights, full remat)
    of full-width ``arch`` (full depth unless ``n_layers``) on one
    repeated batch of ``batch`` x ``seq`` tokens (with seeded random
    side inputs for encdec and vlm), on NVML's energy counter: a falling
    loss, a finite aux and finite tokens/Wh. Fails, naming the depth and
    the card's memory, if the model does not fit: no depth is cut
    beyond ``n_layers``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_data_fn
    from repro_torch.power.methods import NvmlEnergy
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import (StepConfig, init_train_state,
                                        make_train_step)
    full = get_config(arch)
    c = full if n_layers is None else dataclasses.replace(full,
                                                         n_layers=n_layers)
    depth = ("full depth" if c.n_layers == full.n_layers else
             f"cut from {full.n_layers}")
    # a step of Adam moves every parameter by about lr, so the loss's
    # first-order fall is about lr x sum|g| (~3e5 x lr nats over 3.3 B
    # parameters): at 3e-4 the repeated-batch loss overshoots (mamba2
    # 11.23 -> 8.08 -> 12.17, granite-moe rising by step 3 even with the
    # lr ramped to 1.5e-4). lr 1e-6 keeps the three steps first-order, so
    # a correct gradient makes the loss fall
    oc = OptConfig(lr=1e-6, warmup=1, total_steps=1000)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train {arch}] before: {card_memory()}")
    torch.cuda.reset_peak_memory_stats()
    try:
        p, o = init_train_state(
            c, oc, torch.Generator(device=dev).manual_seed(0), dev)
        step = make_train_step(c, oc, StepConfig())
        data = make_data_fn(c, batch, seq, seed=0, device=dev)(0)
        data.update(side_inputs(c, batch, 0, dev))
        power = NvmlEnergy(dev.index or 0)
        losses, ces, auxes, times = [], [], [], []
        torch.cuda.synchronize()
        e0 = sum(power.read().values())
        for _ in range(3):
            t0 = time.perf_counter()
            p, o, m = step(p, o, data)
            losses.append(float(m["loss"]))          # synchronises
            ces.append(float(m["ce"]))
            auxes.append(float(m["aux"]))
            times.append(time.perf_counter() - t0)
        e1 = sum(power.read().values())
    except torch.cuda.OutOfMemoryError as e:
        raise RuntimeError(
            f"[train {arch}] {c.n_layers} layers ({depth}) do not fit: "
            f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
            f"{card_memory()}") from e
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(t.numel() for t in _leaves(p))
    tokens = batch * seq
    step_s = sum(times[1:]) / len(times[1:])
    wh = (e1 - e0) / 3600.0
    tok_wh = 3 * tokens / wh if wh > 0 else float("inf")
    side = {k: tuple(v.shape) for k, v in data.items()
            if k not in ("tokens", "labels")}
    share = ("model_flop_share="
             f"{model_flop_share(c.active_param_count(), tokens, step_s):.4f}"
             " (8 x active params x tokens) " if not side else
             f"side inputs {side} (seeded random) ")
    log(f"[train {arch}] {c.name} n_layers={c.n_layers} ({depth}), "
        f"{n_params:,} params ({c.active_param_count():,} active a token), "
        f"global batch {batch} x seq {seq}, one "
        f"repeated batch, lr {oc.lr:g}: losses {losses} (cross-entropy "
        f"{ces}, aux {auxes}); step times "
        f"{[round(t * 1e3, 1) for t in times]} ms (first includes set-up), "
        f"ms_per_step={step_s * 1e3:.1f} (steps 2-3) tokens_per_s="
        f"{tokens / step_s:.1f} (text tokens) energy_wh={wh:.6e} (3 steps) "
        f"tokens_per_wh={tok_wh:.1f} {share}peak_mem_gb={peak_gb:.2f} "
        f"power_source={power.name}; card {card_line()}")
    assert losses[-1] < losses[0], losses
    assert all(math.isfinite(a) for a in auxes), auxes
    assert math.isfinite(tok_wh) and tok_wh > 0, (wh, tok_wh)
    power.close()
    del p, o, m, data, step
    gc.collect()
    torch.cuda.empty_cache()


def family_train_agreement(arch: str, dev) -> list:
    """Reduced fp32 ``arch``, three AdamW steps from the same weights and
    batches (with seeded random side inputs for encdec and vlm) on the
    card ``dev`` and on the CPU, TF32 off: losses and aux at rtol 1e-4.
    Returns the card's (loss, aux) a step. Phases 9 and 10 and
    ``tests/test_torch_cuda.py`` run it."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.launch.train import make_data_fn
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import (StepConfig, init_train_state,
                                        make_train_step)
    cpu = torch.device("cpu")
    c = get_config(arch).reduced(dtype="float32", param_dtype="float32")
    oc = OptConfig(warmup=2, total_steps=1000)
    step = make_train_step(c, oc, StepConfig())
    state = {cpu: init_train_state(c, oc, torch.Generator().manual_seed(0),
                                   cpu)}
    state[dev] = tree.tree_map(lambda t: t.to(dev), state[cpu])
    metrics = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for d in (cpu, dev):
            p, o = state[d]
            data = make_data_fn(c, 4, 64, seed=0, device=d)
            metrics[d] = []
            for i in range(3):
                p, o, m = step(p, o, {**data(i),
                                      **side_inputs(c, 4, i, d)})
                metrics[d].append((float(m["loss"]), float(m["aux"])))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"[families] reduced fp32 {c.name}, 3 AdamW steps: card "
        f"(loss, aux) {metrics[dev]}, cpu {metrics[cpu]}")
    np.testing.assert_allclose(metrics[dev], metrics[cpu], rtol=1e-4)
    return metrics[dev]


def phase_families(dev, profile: bool = False) -> dict:
    """Phase 9: the moe, ssm and hybrid families served and trained (see
    the module docstring). Returns the largest bf16 error of each paged
    kernel at the serve runs' shapes."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[families] card memory at the phase's start: {card_memory()}")
    worst = phase_families_serve(dev, profile)
    t0 = time.perf_counter()
    for arch in FAMILY_ARCHS:
        family_agreement(arch, dev)
    log(f"[families] card vs cpu serve agreement {time.perf_counter() - t0:.1f} s")
    for arch in ("mamba2-1.3b", "granite-moe-3b-a800m"):
        family_train(dev, arch)
    for arch in FAMILY_ARCHS[:3]:
        family_train_agreement(arch, dev)
    log(f"[wall] phase 9 {time.perf_counter() - t_phase:.1f} s; card "
        f"{card_line()}")
    return worst


# ---------------------------------------------------------------------------
# Phase 10: fixed-batch generate, the encdec and vlm families, degradation
# ---------------------------------------------------------------------------


def profile_generate(engine, tokens, extras, tag: str, steps: int = 5) -> None:
    """``steps`` shared-position decode steps of ``generate``'s program
    (after its prefill and two warm steps) under ``torch.profiler``:
    device launches and device time a step, and the device-busy share of
    the steps' wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.cache import grow_caches
    with torch.no_grad():
        logits, caches, enc_kv = engine._prefill_fn(engine.params, tokens,
                                                    extras)
        n = tokens.shape[1] + (extras["patch_embeds"].shape[1]
                               if "patch_embeds" in extras else 0)
        caches = grow_caches(caches, n + steps + 3)
        tok = logits[:, -1].argmax(-1)[:, None]

        def run(pos0, k):
            for pos in range(pos0, pos0 + k):
                engine._decode_fn(engine.params, tok, caches, pos, enc_kv)
            torch.cuda.synchronize()

        run(n, 2)
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run(n + 2, steps)
            wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    log(f"[profile {tag}] generate decode step (batch {tokens.shape[0]}, "
        f"position {n}): {launches / steps:.0f} device launches, "
        f"{busy_us / steps / 1e3:.3f} ms device time, "
        f"{wall / steps * 1e3:.3f} ms wall a step (profiled); device busy "
        f"{busy_us / 1e6 / wall:.3f} of the wall; card {card_line()}")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:8]:
        log(f"[profile {tag}] {e.self_device_time_total / steps / 1e3:8.3f} "
            f"ms a step {e.count // steps:5d}x  {e.key[:90]}")


def family_generate(dev, tag: str, c, params, text: int, new: int,
                    profile: bool = False) -> dict:
    """``BatchedServer.generate`` of ``GEN_BATCH`` seeded prompts of
    ``text`` tokens (with seeded random side inputs) for ``new`` tokens,
    after a two-token warm-up call, on NVML's energy counter: finite
    prefill logits, in-vocab tokens of the right shape. Logs prefill ms
    (the encoder included), decode tok/s, Wh/token over both, peak GB
    and the q-chunked attention's calls. Returns the calls and the
    result."""
    from repro_torch.models import attention
    from repro_torch.power.methods import NvmlEnergy
    from repro_torch.serve.engine import BatchedServer
    rng = np.random.default_rng(10)
    tokens = torch.from_numpy(rng.integers(0, c.vocab, (GEN_BATCH, text))
                              ).to(dev)
    extras = side_inputs(c, GEN_BATCH, 10, dev)
    server = BatchedServer(c, params, max_len=new + 1, device=dev)
    with torch.no_grad():
        logits, _, _ = server.engine._prefill_fn(params, tokens, extras)
        # the padded vocab's mask (finfo(float32).min) is -inf in bf16
        assert torch.isfinite(logits[..., :c.vocab]).all(), tag
    del logits
    server.generate(tokens, 2, extras)                     # warm-up
    power = NvmlEnergy(dev.index or 0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    calls = attention.sdpa_chunked_q.calls
    torch.cuda.synchronize()
    e0 = sum(power.read().values())
    res = server.generate(tokens, new, extras)
    e1 = sum(power.read().values())
    calls = attention.sdpa_chunked_q.calls - calls
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks = res.tokens.cpu()
    assert toks.shape == (GEN_BATCH, new), toks.shape
    assert int(toks.min()) >= 0 and int(toks.max()) < c.vocab, tag
    seq = text + (c.n_patches if c.family == "vlm" else 0)
    enc = " (encoder included)" if c.family == "encdec" else ""
    wh = (e1 - e0) / 3600.0
    side = {k: tuple(v.shape) for k, v in extras.items()}
    log(f"[{tag}] {c.name} n_layers={c.n_layers} generate: batch "
        f"{GEN_BATCH} x {text} text tokens ({seq} prefill rows), side "
        f"inputs {side} (seeded random), {new} new tokens: prefill_ms="
        f"{res.prefill_s * 1e3:.1f}{enc} decode_ms="
        f"{res.decode_s * 1e3:.1f} decode_tok_s="
        f"{res.decode_tokens_per_s:.1f} decode_step_ms="
        f"{res.decode_s / max(new - 1, 1) * 1e3:.2f} energy_wh={wh:.6e} "
        f"wh_per_token={wh / (GEN_BATCH * new):.3e} (prefill and decode) "
        f"peak_mem_gb={peak_gb:.2f} sdpa_chunked_q calls {calls} "
        f"power_source={power.name}; card {card_line()}")
    if profile:
        profile_generate(server.engine, tokens, extras, tag)
    power.close()
    return {"calls": calls, "tokens": toks, "seq": seq}


def generate_agreement(arch: str, dev) -> float:
    """Reduced fp32 ``arch``, the same weights, prompts and seeded random
    side inputs, through ``BatchedServer.generate`` on the card ``dev``
    and on the CPU, TF32 off: the greedy streams' LCP agreement is at
    least ``STREAM_AGREEMENT``. Returns it. Phase 10 and
    ``tests/test_torch_cuda.py`` both run it."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import BatchedServer
    c = get_config(arch).reduced(dtype="float32", param_dtype="float32")
    cpu_params = lm.init(c, torch.Generator().manual_seed(1), "cpu")
    tokens = np.random.default_rng(1).integers(0, c.vocab, (4, 24))
    streams = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for where, params in (("cpu", cpu_params),
                              ("cuda", _to(cpu_params, dev))):
            d = dev if where == "cuda" else torch.device("cpu")
            res = BatchedServer(c, params, max_len=17, device=d).generate(
                torch.from_numpy(tokens), 16, side_inputs(c, 4, 1, d))
            streams[where] = dict(enumerate(res.tokens.cpu().tolist()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    agree = agreement(streams["cpu"], streams["cuda"])
    log(f"[generate] reduced fp32 {c.name}: card vs cpu generate stream "
        f"agreement {agree:.4f} over {len(tokens)} prompts")
    assert agree >= STREAM_AGREEMENT, (arch, agree)
    return agree


def chunked_q_agreement(dev) -> float:
    """``sdpa_chunked_q`` on the card against full ``sdpa`` under the same
    mask, fp32 with TF32 off, causal, windowed and bidirectional, at
    2 x 1024 queries of 8 heads over 2 KV heads of 64: |diff| <= 1e-5 (1
    + |full|). Returns the largest difference. Phase 10 and
    ``tests/test_torch_cuda.py`` both run it."""
    from repro_torch.models import attention
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(shape, generator=g).to(dev)
               for shape in ((2, 1024, 8, 64), (2, 1024, 2, 64),
                             (2, 1024, 2, 64)))
    worst = 0.0
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            for causal, window in ((True, None), (True, 200), (False, None)):
                calls = attention.sdpa_chunked_q.calls
                got = attention.sdpa_chunked_q(q, k, v, causal=causal,
                                               window=window)
                assert attention.sdpa_chunked_q.calls == calls + 1
                mask = attention.make_causal_mask(
                    1024, 1024, window, device=dev)[None, None] \
                    if causal else None
                want = attention.sdpa(q, k, v, mask)
                err = float(((got - want).abs() / (1 + want.abs())).max())
                log(f"[generate] sdpa_chunked_q on the card vs full sdpa, "
                    f"causal={causal} window={window}: max |diff| / (1 + "
                    f"|full|) {err:.3e}")
                assert err <= 1e-5, (causal, window, err)
                worst = max(worst, err)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return worst


def degrade_engine(c, params, dev):
    from repro_torch.serve.engine import ServeEngine
    return ServeEngine(c, params, n_slots=FAMILY_SLOTS,
                       max_len=FAMILY_MAX_LEN,
                       cache="paged", block_size=BS, sched="chunked",
                       chunk_tokens=32, device=dev)


def fault_twins(dev, tag: str, c, params, reqs, worst: dict) -> dict:
    """A fault-free and a ``decode_fault`` serve of ``reqs`` (all arriving
    at once, so both take the same schedule up to the fault) on fresh
    chunked engines: the slot fault fires and the victim replays, every
    request finishes its budget, and the decode kernel launches once per
    layer and decode micro-step, replays included; the paged kernels are
    held to their plain versions at the shapes the faulted run gave them
    (their worst bf16 errors into ``worst``). Returns each run's streams
    and the fp paged kernels' launches over both."""
    from repro_torch.faults.schedule import FaultSchedule
    from repro_torch.kernels import ops
    out = {"launches": dict.fromkeys(("paged_decode_attention",
                                      "paged_prefill_attention"), 0)}
    for preset in ("none", "decode_fault"):
        engine = degrade_engine(c, params, dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with kept_paged_calls() as kept:
            run = engine.serve(reqs, faults=FaultSchedule.from_preset(
                preset, seed=0))
        wall = time.perf_counter() - t0
        counts = dict(ops.launch_counts())
        micro = sum(st.n_steps for st in run.steps if st.kind == "decode")
        for r, req in zip(sorted(run.results, key=lambda r: r.rid), reqs):
            assert r.finish_reason == "length", (tag, preset, r.rid)
            assert len(r.tokens) == req.max_new_tokens, (tag, preset, r.rid)
        assert counts["paged_decode_attention"] == micro * c.n_layers, (
            tag, preset, counts, micro)
        assert engine.injected_faults == (preset == "decode_fault"), preset
        assert preset == "none" or engine.replayed_tokens >= 1
        for name in out["launches"]:
            out["launches"][name] += counts[name]
        out[preset] = {r.rid: list(r.tokens) for r in run.results}
        log(f"[{tag}] {preset}: {c.name} n_layers={c.n_layers}, "
            f"{len(reqs)} requests at once, chunked: "
            f"injected_faults={engine.injected_faults} preemptions="
            f"{engine.preemptions} replayed_tokens={engine.replayed_tokens} "
            f"decode micro-steps {micro}, launches {counts} "
            f"({counts['paged_decode_attention']} decode = {micro} x "
            f"{c.n_layers}), stream digest {_stream_hash_of(out[preset])}, "
            f"wall {wall:.2f} s")
        if preset == "decode_fault":
            check_paged_calls(tag, kept, worst, dev)
        del engine
    return out


def _stream_hash_of(streams: dict) -> str:
    """``serve_slo``'s stream digest of a rid -> tokens map."""
    from repro_torch.bench.workloads.serve_slo import _stream_hash
    return _stream_hash([types.SimpleNamespace(rid=rid, tokens=toks)
                         for rid, toks in streams.items()])


def phase_degrade(dev, worst: dict) -> dict:
    """10d: the engine's degradation paths on the card, llama3.2-3b at
    full width cut to ``DEGRADE_LAYERS`` layers.

    Slot faults (``fault_twins``) on ``FAMILY_REQUESTS`` serve requests
    (prompts 195-497 tokens, a ``FAMILY_MAX_LEN`` table of 64 blocks):
    the faulted streams' digest must equal the fault-free one. The
    fault moves the table bucket the engine passes the decode kernel at
    the victim's replayed and later steps and at the other slots'; the
    kernel's splits own columns chosen for the whole table
    (``decode_splits(width=)``), so no row's sums change order.

    Shedding, ``DEGRADE_REQUESTS`` requests at once into
    ``FAMILY_SLOTS`` slots: under the ``overload`` preset the newest
    queued requests are shed and the oldest finishes its budget; with a
    50 ms admission deadline on the newest half, those shed while the
    first wave is served. Returns the fp paged kernels' launches in the
    slot-fault runs."""
    t_phase = time.perf_counter()
    from repro_torch.faults.schedule import FaultSchedule
    c, params = family_model(dev, "llama3.2-3b", n_layers=DEGRADE_LAYERS)
    reqs = family_requests(c.vocab, FAMILY_REQUESTS, at_once=True)
    twins = fault_twins(dev, "degrade", c, params, reqs, worst)
    diverge = {rid: next((i for i, (a, b) in enumerate(zip(
        toks, twins["decode_fault"][rid])) if a != b), None)
        for rid, toks in twins["none"].items()}
    log(f"[degrade] slot-faulted vs fault-free stream agreement "
        f"{agreement(twins['none'], twins['decode_fault']):.4f}, first "
        f"differing token by rid {diverge}")
    assert twins["none"] == twins["decode_fault"], diverge
    log("[degrade] slot-faulted streams equal the fault-free streams")
    launches = twins["launches"]

    many = family_requests(c.vocab, DEGRADE_REQUESTS, at_once=True)
    engine = degrade_engine(c, params, dev)
    faults = FaultSchedule.from_preset("overload", seed=0)
    out = engine.serve(many, faults=faults)
    shed = sorted(r.rid for r in out.results if r.finish_reason == "shed")
    ev = faults.events[0]
    log(f"[degrade] overload preset (cap {ev.n} from poll {ev.at} for "
        f"{ev.span} polls), {len(many)} requests at once into "
        f"{FAMILY_SLOTS} slots: shed {engine.shed} {shed}")
    assert engine.shed == len(shed) >= 1, shed
    assert shed == list(range(len(many) - len(shed), len(many))), shed
    by = out.by_rid()
    assert by[0].finish_reason == "length" and \
        by[0].n_tokens == many[0].max_new_tokens
    for r in out.results:
        assert (r.n_tokens == 0) == (r.rid in shed), r.rid
    half = len(many) // 2
    late = [dataclasses.replace(r, deadline_s=0.05) if r.rid >= half else r
            for r in many]
    out = engine.serve(late)
    shed = sorted(r.rid for r in out.results if r.finish_reason == "shed")
    log(f"[degrade] admission deadline 50 ms on rids {half}-"
        f"{len(many) - 1}: shed {engine.shed} {shed}")
    assert shed and min(shed) >= half, shed
    by = out.by_rid()
    assert by[0].finish_reason == "length" and \
        by[0].n_tokens == many[0].max_new_tokens
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[wall] phase 10d {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_generate(dev, profile: bool = False) -> tuple:
    """Phase 10 (see the module docstring). Returns the fp paged kernels'
    launches in 10d and the largest bf16 error of each paged kernel at
    10d's shapes."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[generate] card memory at the phase's start: {card_memory()}")
    c, params = family_model(dev, "whisper-small")
    family_generate(dev, "encdec", c, params, WHISPER_PROMPT, WHISPER_GEN,
                    profile=profile)
    del params
    family_train(dev, "whisper-small", batch=GEN_BATCH,
                 seq=WHISPER_TRAIN_SEQ)
    log(f"[wall] phase 10a {time.perf_counter() - t_phase:.1f} s")

    t0 = time.perf_counter()
    c, params = family_model(dev, "llava-next-34b", n_layers=LLAVA_LAYERS)
    run = family_generate(dev, "vlm", c, params, LLAVA_TEXT, LLAVA_GEN,
                          profile=profile)
    elems = GEN_BATCH * c.n_heads * run["seq"] ** 2
    from repro_torch.models.attention import CHUNK_THRESHOLD
    log(f"[vlm] prefill score elements {GEN_BATCH} x {c.n_heads} x "
        f"{run['seq']}^2 = {elems:.3e} > CHUNK_THRESHOLD {CHUNK_THRESHOLD:.3e}"
        f": sdpa_chunked_q ran {run['calls']} times ({c.n_layers} layers)")
    assert elems > CHUNK_THRESHOLD and run["calls"] == c.n_layers, run
    del params, run
    gc.collect()
    torch.cuda.empty_cache()
    family_train(dev, "llava-next-34b", n_layers=LLAVA_TRAIN_LAYERS,
                 batch=LLAVA_TRAIN_BATCH, seq=LLAVA_TEXT)
    log(f"[wall] phase 10b {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    for arch in ("whisper-small", "llava-next-34b"):
        generate_agreement(arch, dev)
        family_train_agreement(arch, dev)
    chunked_q_agreement(dev)
    log(f"[wall] phase 10c {time.perf_counter() - t0:.1f} s")

    worst = dict.fromkeys(("paged_decode_attention", DECODE_INT8,
                           "paged_prefill_attention", INT8), 0.0)
    launches = phase_degrade(dev, worst)
    log(f"[wall] phase 10 {time.perf_counter() - t_phase:.1f} s; card "
        f"{card_line()}")
    return launches, worst


def phase_heatmap(dev) -> None:
    """11a: the ``heatmap`` workload's whole Space through the bench CLI on
    NVML's energy counter: dp1 cells ``ok`` at full gpt-117m width with a
    falling loss and finite tokens/s and tokens/Wh, dp2-dp8 ``deferred``
    with their sbatch files."""
    from repro_torch.bench import cli
    from repro_torch.bench.records import load_records
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        rc = cli.main(["run", "--suite", "heatmap", "--device", "cuda",
                       "--power", "auto", "--out", out, "--quiet"])
        records = load_records(f"{out}/heatmap/results.json")
        deferred = [r for r in records if r.point["placement"] != "dp1"]
        scripts = [Path(r.metrics.get("slurm_script", "")) for r in deferred]
        assert all(p.is_file() and "repro_torch.bench" in p.read_text()
                   for p in scripts), scripts
    log(f"[heatmap] heatmap Space: rc {rc}, {len(records)} records in "
        f"{time.perf_counter() - t0:.1f} s")
    assert rc == 0, rc
    measured = [r for r in records if r.point["placement"] == "dp1"]
    assert sorted(r.point["global_batch"] for r in measured) == [8, 16, 32]
    for r in measured:
        m = r.metrics
        log(f"[heatmap] dp1 gb={r.point['global_batch']}: tokens_per_s="
            f"{m.get('tokens_per_s', 0):.1f} ms={m.get('ms', 0):.3f} "
            f"iters={m.get('iters')} energy_wh={m.get('energy_wh', 0):.6e} "
            f"tokens_per_wh={m.get('tokens_per_wh', 0):.1f} mean_w="
            f"{m.get('energy_wh', 0) * 3600 / max(m.get('seconds', 1), 1e-9):.1f}"
            f" mfu={m.get('mfu', 0):.5f} peak_mem_gb="
            f"{m.get('peak_mem_gb', 0):.2f} loss {m.get('loss_first', 0):.4f}"
            f" -> {m.get('loss_last', 0):.4f} rel_spread="
            f"{r.noise.get('rel_std')} power_source={r.power_source} "
            f"model_scale={m.get('model_scale')} n_params={m.get('n_params')}")
    for r in measured:
        m = r.metrics
        assert r.status == "ok", (r.point, r.error)
        assert r.power_source == "nvml_energy", (r.point, r.power_source)
        assert m["model_scale"] == "full", r.point
        assert m["loss_last"] < m["loss_first"], (r.point, m)
        assert m["seconds"] * m["iters"] >= 0.5, (r.point, m)
        for k in ("tokens_per_s", "tokens_per_wh", "mfu"):
            assert math.isfinite(m[k]) and m[k] > 0, (r.point, k, m[k])
    assert sorted((r.point["placement"], r.point["global_batch"])
                  for r in deferred) == [(plc, gb) for plc in
                                         ("dp2", "dp4", "dp8")
                                         for gb in (8, 16, 32)], records
    assert all(r.status == "deferred" for r in deferred), deferred
    log(f"[heatmap] dp2-dp8: {len(deferred)} records deferred, each with "
        f"its sbatch file ({deferred[0].error})")


def phase_quickstart(dev) -> None:
    """11b: the quickstart's pipeline at its ``--full-117m`` shape:
    synthetic OSCAR -> tokenizer -> indexed dataset -> sharded loader ->
    ``train_loop`` with checkpointing, full gpt-117m, on NVML's energy
    counter; the loss must fall."""
    from repro_torch.configs import get_config
    from repro_torch.data.indexed import (IndexedDatasetReader,
                                          IndexedDatasetWriter)
    from repro_torch.data.loader import ShardedLoader, lm_sample_fn
    from repro_torch.data.synthetic import synthetic_oscar_text
    from repro_torch.data.tokenizer import ByteFallbackTokenizer
    from repro_torch.power.ctxmgr import get_power
    from repro_torch.power.methods import NvmlEnergy
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import (StepConfig, init_train_state,
                                        make_train_step)

    t0 = time.perf_counter()
    c = get_config("gpt-117m")
    steps, gb, seq = QUICKSTART_STEPS, QUICKSTART_BATCH, QUICKSTART_SEQ
    docs = synthetic_oscar_text(QUICKSTART_DOCS, seed=0)
    tok = ByteFallbackTokenizer.train(docs, max_vocab=c.vocab)
    with tempfile.TemporaryDirectory() as tmp:
        w = IndexedDatasetWriter(Path(tmp) / "oscar")
        for d in docs:
            w.add_document(tok.encode(d))
        w.finalize(meta={"tokenizer": "byte-fallback", "docs": len(docs)})
        reader = IndexedDatasetReader(Path(tmp) / "oscar")
        t_data = time.perf_counter() - t0
        log(f"[quickstart] {reader.n_documents} docs, {reader.n_tokens:,} "
            f"tokens, {len(tok.word_to_id)} words in the vocabulary: "
            f"tokenizer + indexed dataset {t_data:.1f} s")
        oc = OptConfig(lr=3e-4, warmup=max(steps // 20, 5),
                       total_steps=steps)
        gen = torch.Generator(device=dev).manual_seed(0)
        params, opt_state = init_train_state(c, oc, gen, dev)
        n_params = sum(p.numel() for p in _leaves(params))
        step = make_train_step(c, oc, StepConfig())
        loader = ShardedLoader(lm_sample_fn(reader, seq), gb)
        waits = []

        def batches():
            while True:
                t = time.perf_counter()
                b = next(loader)
                out = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                waits.append(time.perf_counter() - t)
                yield out

        cfg = LoopConfig(total_steps=steps, ckpt_every=max(steps // 2, 10),
                         ckpt_dir=str(Path(tmp) / "ckpt"),
                         log_every=max(steps // 6, 5), seq_len=seq,
                         global_batch=gb)
        power = NvmlEnergy(dev.index or 0)
        try:
            t_loop = time.perf_counter()
            with get_power([power], interval_ms=100) as scope:
                res = train_loop(step, params, opt_state, batches(), cfg)
            wall = time.perf_counter() - t_loop
        finally:
            loader.close()
        ckpts = sorted(p.name for p in (Path(tmp) / "ckpt").iterdir())
    wh = scope.total_energy_wh()
    n_tok = res.steps_run * gb * seq
    log(f"[quickstart] gpt-117m ({n_params:,} params), {res.steps_run} steps "
        f"of {gb} x {seq}: loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}; "
        f"{res.tokens_per_s:,.1f} tokens/s over the loop's {wall:.2f} s, "
        f"{wh:.6f} Wh ({power.name}) -> {n_tok / wh:,.1f} tokens/Wh, mean "
        f"{wh * 3600 / wall:.1f} W; loader wait {sum(waits):.3f} s = "
        f"{sum(waits) / wall:.4f} of the loop's wall (max "
        f"{max(waits) * 1e3:.2f} ms a batch); checkpoints {ckpts}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    assert res.steps_run == steps and res.losses[-1] < res.losses[0], res
    assert math.isfinite(n_tok / wh) and wh > 0, wh
    del params, opt_state, step
    gc.collect()
    torch.cuda.empty_cache()


def fallback_probe(dev, window_s: float = FALLBACK_WINDOW_S,
                   fail_from: int = FALLBACK_FAIL_FROM) -> dict:
    """``FallbackPower(NvmlEnergy, NvmlPower)`` whose primary fails from
    read ``fail_from`` on, beside an unfaulted ``NvmlEnergy``, over
    ``window_s`` of steady matmul load: both scopes' Wh, the wrapper's
    label, kind, reads and whether it degraded."""
    from repro_torch.faults.schedule import FlakyPower
    from repro_torch.power.ctxmgr import get_power
    from repro_torch.power.methods import FallbackPower, NvmlEnergy, NvmlPower

    idx = dev.index or 0
    fb = FallbackPower(FlakyPower(NvmlEnergy(idx), fail_from=fail_from,
                                  fail_count=10 ** 9), NvmlPower(idx))
    counter = NvmlEnergy(idx)
    a = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)
    t_end = time.perf_counter() + 1.0          # ramp up before the window
    while time.perf_counter() < t_end:
        a @ a
        torch.cuda.synchronize()
    with get_power([fb], FALLBACK_INTERVAL_MS) as s_fb, \
            get_power([counter], FALLBACK_INTERVAL_MS) as s_counter:
        t_end = time.perf_counter() + window_s
        while time.perf_counter() < t_end:
            for _ in range(8):
                a @ a
            torch.cuda.synchronize()
    wh_fb, wh = s_fb.total_energy_wh(), s_counter.total_energy_wh()
    return {"wh_fallback": wh_fb, "wh_counter": wh, "label": fb.label,
            "kind": fb.kind, "reads": fb.primary.reads,
            "fallback_reads": fb.fallback_reads, "degraded": fb.degraded,
            "rel_err": abs(wh_fb - wh) / wh,
            "columns": sorted(s_fb.counter_cols), "seconds": window_s}


def rapl_probe(dev, window_s: float = 2.0) -> dict:
    """Whether the host exposes readable powercap zones, and if it does,
    their watts over ``window_s`` of matmul load."""
    from repro_torch.power.methods import RaplPower
    rapl = RaplPower()
    out = {"root": rapl.root, "zones": rapl.devices(),
           "available": rapl.available()}
    if out["available"]:
        rapl.read()
        a = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)
        t_end = time.perf_counter() + window_s
        while time.perf_counter() < t_end:
            a @ a
            torch.cuda.synchronize()
        out["watts"] = rapl.read()
    return out


def profile_heatmap_step(dev) -> None:
    """One full-width gpt-117m step of the heatmap's gb=32 dp1 cell under
    ``torch.profiler``: the device-busy share of its wall, its launches
    and its device time by kind and range."""
    from repro_torch.bench.workloads import heatmap
    from repro_torch.data.synthetic import synthetic_tokens
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import (StepConfig, init_train_state,
                                        make_train_step)
    c, _ = heatmap.config(dev)
    oc = OptConfig(warmup=1, total_steps=100)
    state = list(init_train_state(
        c, oc, torch.Generator(device=dev).manual_seed(0), dev))
    n_params = sum(t.numel() for t in _leaves(state[0]))
    step = make_train_step(c, oc, StepConfig())
    gb, seq = 32, heatmap.SEQ
    toks = torch.from_numpy(synthetic_tokens(gb, seq, c.vocab)[:, :seq])
    toks = toks.to(dev)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}

    def one():
        state[:] = step(*state, batch)[:2]

    for _ in range(2):                      # warm: allocator, handles
        one()
    r = profile_step("profile heatmap", one, _kernel_kind,
                     ("gemms", "elementwise", "copies"))
    wall, busy = r["wall"], r["busy"]
    log(f"[profile heatmap] gpt-117m gb={gb} seq={seq} dp1: wall "
        f"{wall * 1e3:.2f} ms (profiled), device busy {busy:.2f} ms = "
        f"{busy / 1e3 / wall:.4f} of wall, {r['launches']} device events, "
        f"{wall / max(r['launches'], 1) * 1e6:.1f} us of wall a launch; mfu "
        f"over the profiled wall "
        f"{6 * n_params * gb * seq / wall / PEAK_FLOPS[torch.bfloat16]:.5f}")
    log("[profile heatmap] device ms by kind: " + ", ".join(
        f"{k} {v:.2f} ({v / busy:.3f})" for k, v in r["by_kind"].items()))
    log("[profile heatmap] device ms by range: " + ", ".join(
        f"{k} {v:.2f}" for k, v in r["ranges"].items()))
    del state
    gc.collect()
    torch.cuda.empty_cache()


def phase_harness(dev, profile: bool = False) -> None:
    """Phase 11 (see the module docstring)."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    phase_heatmap(dev)
    log(f"[wall] phase 11a {time.perf_counter() - t_phase:.1f} s")
    if profile:
        profile_heatmap_step(dev)
    t0 = time.perf_counter()
    phase_quickstart(dev)
    log(f"[wall] phase 11b {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rapl = rapl_probe(dev)
    log(f"[power] RAPL under {rapl['root']}: zones {rapl['zones']}, "
        f"readable {rapl['available']}"
        + (f", watts over 2 s of load {rapl['watts']}" if rapl["available"]
           else ""))
    if rapl["available"]:
        assert all(math.isfinite(v) for v in rapl["watts"].values()), rapl
    fb = fallback_probe(dev)
    log(f"[power] FallbackPower(NvmlEnergy, NvmlPower), primary failing from "
        f"read {FALLBACK_FAIL_FROM}: {fb['wh_fallback']:.6f} Wh against the "
        f"unfaulted counter's {fb['wh_counter']:.6f} Wh over "
        f"{fb['seconds']:.0f} s of matmul load: rel err {fb['rel_err']:.5f}"
        f" (gate {FALLBACK_TOL}); label {fb['label']}, kind {fb['kind']}, "
        f"primary reads {fb['reads']}, fallback reads "
        f"{fb['fallback_reads']}, degraded {fb['degraded']}")
    assert fb["label"] == "nvml_energy+fallback:nvml", fb
    assert fb["kind"] == "energy" and fb["degraded"], fb
    assert fb["rel_err"] <= FALLBACK_TOL, fb
    log(f"[wall] phase 11c {time.perf_counter() - t0:.1f} s")
    log(f"[wall] phase 11 {time.perf_counter() - t_phase:.1f} s; card "
        f"{card_line()}")


REPLACES = {
    "paged_decode_attention": "src/repro/kernels/decode_attention.py:155",
    "paged_prefill_attention": "src/repro/kernels/prefill_attention.py:217",
    INT8: "src/repro/kernels/prefill_attention.py:217",
    DECODE_INT8: "src/repro/kernels/decode_attention.py:155",
    "flash_attention": "src/repro/kernels/flash_attention.py:106",
    "rmsnorm": "src/repro/kernels/rmsnorm.py:40",
}


#: phase 12b: (arch, shape, batch) of the real steps held against the
#: dry run's counts; the batch cut where one card does not hold the
#: cell's, and listed in the record's ``reduced``
REAL_STEP_CELLS = (("qwen2-0.5b", "decode_32k", None),
                   ("mamba2-1.3b", "decode_32k", None),
                   ("mamba2-1.3b", "long_500k", None),
                   ("qwen2-0.5b", "prefill_32k", 1),
                   ("qwen2-0.5b", "train_4k", 4))
#: phase 12b: |measured - estimated| peak bytes over the estimate
PEAK_TOL = 0.10
#: phase 12a: the dry run's cell processes (the card machine's cores)
DRYRUN_WORKERS = 8
#: phase 1: (arch, H, Kh, Dh) of the grouped-vs-repeat dense decode check
GROUPED_SHAPES = (("llama3.2-3b", 24, 8, 128), ("llava-next-34b", 56, 8, 128))


def check_grouped_decode(dev) -> None:
    """The dense decode's grouped ``sdpa`` against its repeat one, bf16
    on the card, at full llama3.2-3b and llava-next-34b head shapes: 8
    rows at per-row positions over a 4096-row cache, under phase 1's
    gate."""
    from repro_torch.models import attention
    gen = torch.Generator(device=dev).manual_seed(12)
    for arch, h, kh, dh in GROUPED_SHAPES:
        b, t = 8, 4096
        q = torch.randn((b, 1, h, dh), generator=gen, device=dev)
        k = torch.randn((b, t, kh, dh), generator=gen, device=dev)
        v = torch.randn((b, t, kh, dh), generator=gen, device=dev)
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        pos = torch.randint(0, t, (b, 1), generator=gen, device=dev)
        mask = (torch.arange(t, device=dev)[None, :] <= pos)[:, None, None]
        got = attention.sdpa(q, k, v, mask, impl="grouped")
        want = attention.sdpa(q, k, v, mask, impl="repeat")
        torch.cuda.synchronize()
        err, ratio, share = check_close(got, want, torch.bfloat16)
        log(f"[kernels] grouped dense decode {arch} H={h} Kh={kh} Dh={dh} "
            f"B={b} T={t} bf16 vs repeat: max_err={err:.3e} "
            f"max_err_ratio={ratio:.3e} mismatch_share={share:.3e}")


def phase_dryrun(dev) -> None:
    """Phase 12: (a) the dry run of every (arch x shape) cell on ``meta``
    (``launch.dryrun.run_cells``, ``DRYRUN_WORKERS`` processes): 33 cells
    ``ok``, the 7 ``long_500k`` cells of quadratic attention skipped, 0
    failed, its table and wall printed; (b) real steps on the card of
    ``REAL_STEP_CELLS``: FLOPs under ``FlopCounterMode`` on CUDA tensors
    equal the meta count exactly, ``max_memory_allocated`` within
    ``PEAK_TOL`` of the meta estimate, and the step time beside the
    roofline bound (printed, not gated)."""
    from repro_torch.configs import ASSIGNED, SHAPES, get_config, skipped_cells
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    results = dryrun.run_cells(list(ASSIGNED), list(SHAPES),
                               [dryrun.MESH], dryrun.ART,
                               workers=DRYRUN_WORKERS)
    wall = time.perf_counter() - t0
    ok = [r for r in results if "roofline" in r]
    skipped = [r for r in results if "skipped" in r]
    failed = [r for r in results if "error" in r]
    log(f"[dryrun] {'arch':26s} {'shape':12s} {'TFLOP':>10s} "
        f"{'TB moved':>10s} {'peak GB':>9s} fits80 {'bound':10s} "
        f"{'bound s':>10s}")
    for r in ok:
        rf = r["roofline"]
        log(f"[dryrun] {r['arch']:26s} {r['shape']:12s} "
            f"{r['cost_analysis']['flops'] / 1e12:10.2f} "
            f"{r['cost_analysis']['bytes_accessed'] / 1e12:10.3f} "
            f"{r['bytes_per_device'] / 1e9:9.2f} "
            f"{str(r['fits_hbm_80g']):6s} {rf['bottleneck']:10s} "
            f"{rf['step_time_s']:10.4f}")
    for r in skipped:
        log(f"[dryrun] {r['arch']:26s} {r['shape']:12s} skipped: "
            f"{r['skipped']}")
    log(f"[dryrun] {len(ok)} ok, {len(skipped)} skipped, {len(failed)} "
        f"failed in {wall:.1f} s ({DRYRUN_WORKERS} processes, meta)")
    assert not failed, [(r["arch"], r["shape"], r["error"]) for r in failed]
    assert (len(ok), len(skipped)) == (33, 7), (len(ok), len(skipped))
    assert {(r["arch"], r["shape"]) for r in skipped} == \
        {(a, "long_500k") for a, _s, _why in skipped_cells()}
    for arch, sname, batch in REAL_STEP_CELLS:
        shape = SHAPES[sname]
        reduced = {}
        if batch is not None and batch != shape.global_batch:
            reduced = {"global_batch": [shape.global_batch, batch]}
            shape = dataclasses.replace(shape, global_batch=batch)
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        rec = dryrun.real_step(get_config(arch), shape, dev)
        rec["reduced"] = reduced
        est, got = rec["peak_bytes_estimate"], rec["peak_bytes_measured"]
        rec["peak_rel_err"] = (got - est) / est
        rec["wall_s"] = time.perf_counter() - t1
        log(f"[dryrun] real step {json.dumps(rec)}")
        log(f"[dryrun] real step {arch} {sname} B={shape.global_batch}: "
            f"{rec['step_ms']:.2f} ms, bound {rec['bound_ms']:.3f} ms "
            f"({rec['bottleneck']}), share {rec['roofline_share']:.4f}; "
            f"peak {got / 1e9:.3f} GB measured vs {est / 1e9:.3f} GB "
            f"estimated ({rec['peak_rel_err']:+.4f}); FLOPs "
            f"{rec['flops_device']:.6e} card vs {rec['flops_meta']:.6e} meta")
        assert rec["flops_device"] == rec["flops_meta"], rec
        assert abs(rec["peak_rel_err"]) <= PEAK_TOL, (
            f"{arch} {sname}: peak {got} B measured, {est} B estimated")
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[wall] phase 12 {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 13: data-parallel and pipeline-parallel ranks on one card
# ---------------------------------------------------------------------------

#: phase 13: every number it prints carries this note beside the card
PAR_NOTE = "ranks share one card over gloo; not a scaling number"
#: 13a: llm_train's dp2 cell on full-width gpt-800m (sequence, global
#: batch, steps); 13c: pipeline_gpt's pp4 forward on full-width gpt-117m
PAR_SEQ, PAR_BATCH, PAR_STEPS = 128, 16, 3
#: 13a syncs the accumulated gradients once a step: the card's default
#: (each microbatch's buckets as they come) moves 4x the bytes through
#: gloo's host all-reduce, 12-37 s a step on an H100 at 700 W against
#: 5-9 s, and overlaps nothing on one card; 13b runs the overlapped path
PAR_OVERLAP = False
PP_BATCH = 32


def _par(msg: str, card: str) -> None:
    log(f"[parallel] {msg} ({card}; {PAR_NOTE})")


def _digest(tree_) -> str:
    """sha256 over every leaf's bytes, in the reference's leaf order."""
    import hashlib
    from repro_torch.core import tree
    h = hashlib.sha256()
    for x in tree.leaves(tree_):
        h.update(x.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def _ranks_wait(world) -> None:
    """Wait for the card and, in a world of ranks, for every rank."""
    if world.device.type == "cuda":
        torch.cuda.synchronize(world.device)
    if torch.distributed.is_initialized():
        torch.distributed.barrier()


def _dp_lm(world, c, mode: str, k: int, seq: int, gb: int, steps: int,
           overlap=None, cpu_init: bool = False):
    """``steps`` dp steps of ``make_dp_train_step`` from seeded weights on
    this rank's world: (losses, ms a step, params, sync state). The
    weights are drawn on the run's device, or with ``cpu_init`` on the
    CPU and copied (the same weights on the card and on the CPU)."""
    from repro_torch.bench.spec import Placement
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import tree
    from repro_torch.data.synthetic import synthetic_tokens
    from repro_torch.launch.mesh import mesh_for
    from repro_torch.parallel import grad_sync as gs
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import StepConfig, init_train_state
    dev = world.device
    oc = OptConfig(warmup=2, total_steps=1000)
    at = torch.device("cpu") if cpu_init else dev
    p, o = init_train_state(c, oc, torch.Generator(device=at).manual_seed(0),
                            at)
    p, o = tree.tree_map(lambda t: t.to(dev), (p, o))
    plan = shd.make_plan(c, mesh_for(Placement.of(f"dp{world.world_size}")),
                         ShapeConfig("par", seq, gb, "train"))
    p, o, zero = shd.shard_train_state(plan, p, o, c)
    sync = gs.default_sync(mode, dev)
    if overlap is not None:
        sync = dataclasses.replace(sync, overlap=overlap)
    step = gs.make_dp_train_step(c, oc, StepConfig(microbatches=k),
                                 plan=plan, sync=sync, zero=zero)
    s = gs.init_sync_state(p, sync)
    toks = torch.from_numpy(synthetic_tokens(gb, seq, c.vocab)[:, :seq])
    batch = {"tokens": toks.to(dev), "labels": torch.roll(toks, -1, 1).to(dev)}
    losses, ms = [], []
    for _ in range(steps):
        _ranks_wait(world)
        t0 = time.perf_counter()
        p, o, s, m = step(p, o, s, batch)
        losses.append(float(m["loss"]))
        _ranks_wait(world)
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, p, s, sync


def _dp_resnet(world_or_dev, steps: int = 3):
    """Reduced fp32 ResNet, ``steps`` AdamW steps on one global batch:
    under a dp2 plan (BatchNorm synced) in a world, else on one device."""
    from repro_torch.bench.spec import Placement
    from repro_torch.configs.resnet50 import CONFIG
    from repro_torch.data.synthetic import synthetic_images
    from repro_torch.launch.mesh import mesh_for
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.core import tree
    from repro_torch.train.step import init_train_state, make_resnet_train_step
    world = None if isinstance(world_or_dev, torch.device) else world_or_dev
    dev = world_or_dev if world is None else world.device
    c = CONFIG.reduced(img_size=64, width=16, dtype="float32",
                       param_dtype="float32")
    oc = OptConfig(warmup=2, total_steps=1000)
    p, o = init_train_state(c, oc, torch.Generator().manual_seed(0),
                            torch.device("cpu"))
    p, o = tree.tree_map(lambda t: t.to(dev), (p, o))
    kw = {}
    if world is not None:
        plan = shd.make_dp_plan(mesh_for(Placement.of("dp2")))
        p, o, zero = shd.shard_train_state(plan, p, o)
        kw = {"plan": plan, "zero": zero}
    step = make_resnet_train_step(c, oc, **kw)
    imgs, labels = synthetic_images(8, c.img_size, c.n_classes)
    batch = {"images": torch.from_numpy(imgs).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}
    losses = []
    for _ in range(steps):
        p, o, m = step(p, o, batch)
        losses.append(float(m["loss"]))
    return losses


def par_rank_dp(world, card: str) -> dict:
    """Phase 13a and 13b's card side, one rank of two on one card."""
    from repro_torch.bench.workloads.llm_train import _microbatches
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": world.rank}
    # 13a: full-width gpt-800m, llm_train's dp2 cell, fp32 sync
    c = get_config("gpt-800m")
    k = _microbatches(PAR_BATCH, world.world_size)
    torch.cuda.reset_peak_memory_stats(world.device)
    losses, ms, p, _, sync = _dp_lm(world, c, "fp32", k, PAR_SEQ, PAR_BATCH,
                                    PAR_STEPS, overlap=PAR_OVERLAP)
    out["13a"] = {"losses": losses, "ms": ms, "k": k,
                  "overlap": sync.overlap,
                  "peak_gb": torch.cuda.max_memory_allocated(world.device)
                  / 1e9, "digest": _digest(p)}
    del p
    gc.collect()
    torch.cuda.empty_cache()
    # 13b: reduced fp32 gpt-800m, fp32 and int8 sync; reduced ResNet
    rc = get_config("gpt-800m").reduced(dtype="float32",
                                        param_dtype="float32")
    for mode, overlap in (("fp32", None), ("int8", False)):
        losses, _, p, s, sync = _dp_lm(world, rc, mode, 4, 64, 16, 3,
                                       overlap=overlap, cpu_init=True)
        out[f"13b-{mode}"] = {"losses": losses, "sync": s.cpu().numpy(),
                              "digest": _digest(p),
                              "overlap": sync.overlap}
    out["13b-resnet"] = _dp_resnet(world)
    return out


def par_rank_int8(world) -> dict:
    """The reduced fp32 gpt-800m's int8 dp run on this rank's world (13b
    holds the card's ranks against CPU ranks)."""
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    rc = get_config("gpt-800m").reduced(dtype="float32",
                                        param_dtype="float32")
    losses, _, _, s, _ = _dp_lm(world, rc, "int8", 4, 64, 16, 3,
                                overlap=False, cpu_init=True)
    return {"losses": losses, "sync": s.cpu().numpy()}


def par_rank_pipeline(world) -> dict:
    """Phase 13c: pipeline_gpt's pp4 forward at full gpt-117m width, one
    stage a rank; rank 0 also runs the same layers in sequence."""
    from repro_torch.bench.spec import Placement
    from repro_torch.bench.workloads.pipeline_gpt import (
        N_MICROBATCH, N_STAGES, SEQ, layer_fn_for)
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import synthetic_tokens
    from repro_torch.launch.mesh import mesh_for
    from repro_torch.models import lm
    from repro_torch.parallel.pipeline import (bubble_fraction,
                                               pipeline_forward,
                                               stage_params_split)
    dev = world.device
    c = get_config("gpt-117m")
    params = lm.init(c, torch.Generator(device=dev).manual_seed(0), dev)
    mesh = mesh_for(Placement.of({"pp": N_STAGES}))
    fn = layer_fn_for(c)
    sp = stage_params_split(params["layers"], N_STAGES)
    toks = torch.from_numpy(synthetic_tokens(PP_BATCH, SEQ, c.vocab)[:, :SEQ])
    out = {"rank": world.rank, "bubble": bubble_fraction(N_STAGES,
                                                         N_MICROBATCH)}
    with torch.no_grad():
        x = lm._inputs_to_embeds(c, params, toks.to(dev), None)
        x_mb = x.reshape(N_MICROBATCH, PP_BATCH // N_MICROBATCH, SEQ,
                         c.d_model)
        ms = []
        for _ in range(4):
            _ranks_wait(world)
            t0 = time.perf_counter()
            y = pipeline_forward(mesh, "stage", fn, sp, x_mb)
            _ranks_wait(world)
            ms.append((time.perf_counter() - t0) * 1e3)
        out["ms"] = ms
        if world.rank == 0:
            want = fn(params["layers"], x)
            err, ratio, share = check_close(y.reshape(want.shape), want,
                                            torch.bfloat16)
            out["gate"] = (err, ratio, share)
    return out


def phase_parallel(dev) -> None:
    """Phase 13: data-parallel and pipeline-parallel ranks through gloo on
    the one card (``launch.mesh.spawn(..., backend="gloo")``): (a)
    llm_train's dp2 step on full-width gpt-800m, equal param digests
    across ranks; (b) reduced fp32 gpt-800m dp2 against dp1 on the card
    (losses at rtol 1e-4), its int8 sync against the same run on CPU
    ranks (error-feedback codes within one, in at most 0.1 % of
    entries), the dp2 ResNet step with synced BatchNorm against dp1;
    (c) pipeline_gpt's pp4 forward at full gpt-117m width against the
    sequential forward under phase 1's bf16 gate."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn
    t_start = time.perf_counter()
    torch.empty(1, device=dev)      # this process's context, for its stats
    card = card_line()
    log(f"[parallel] ranks share one card: gloo (launch.mesh.spawn, "
        f"backend='gloo'), not nccl, which takes one card a rank")
    c = get_config("gpt-800m")
    n = c.param_count()
    gb = 1e-9
    k = 4
    reckon = {"params bf16": 2 * n * gb, "one microbatch's bf16 grads":
              2 * n * gb, "fp32 grad accumulator": 4 * n * gb,
              "fp32 bucket copy of the grads": 4 * n * gb,
              "AdamW m, v, master: half under ZeRO-1": 3 * 4 * n * gb / 2}
    log(f"[parallel] 13a reckoning per rank, {n / 1e9:.3f} B params: "
        + ", ".join(f"{key} {v:.1f} GB" for key, v in reckon.items())
        + f"; about {sum(reckon.values()):.1f} GB before activations "
        f"(microbatches {k})")
    t0 = time.perf_counter()
    ranks = spawn(par_rank_dp, 2, args=(card,), device=dev, backend="gloo")
    t_dp = time.perf_counter() - t0
    for r in ranks:
        a = r["13a"]
        _par(f"13a gpt-800m dp2 rank {r['rank']}: seq {PAR_SEQ}, global "
             f"batch {PAR_BATCH}, microbatches {a['k']}, fp32 sync "
             f"overlap={a['overlap']}: losses {a['losses']}, ms a step "
             f"{[round(x, 1) for x in a['ms']]}, max_memory_allocated "
             f"{a['peak_gb']:.2f} GB (reckoned ~{sum(reckon.values()):.1f} "
             f"GB), params digest {a['digest']}", card)
    digests = {r["13a"]["digest"] for r in ranks}
    assert len(digests) == 1, f"rank param digests differ: {digests}"
    one = types.SimpleNamespace(rank=0, world_size=1, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    full1, ms1, p1, _, _ = _dp_lm(one, c, "fp32", k, PAR_SEQ, PAR_BATCH,
                                  PAR_STEPS, overlap=PAR_OVERLAP)
    del p1
    gc.collect()
    torch.cuda.empty_cache()
    _par(f"13a gpt-800m dp1 beside it (one process, the same global "
         f"batch and steps): losses {full1}, ms a step "
         f"{[round(x, 1) for x in ms1]}, max_memory_allocated "
         f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB", card)
    assert all(np.isfinite(r["13a"]["losses"]).all() for r in ranks)
    for mode in ("fp32", "int8"):
        assert ranks[0][f"13b-{mode}"]["digest"] == \
            ranks[1][f"13b-{mode}"]["digest"], mode
    # 13b: dp1 on the card, int8 dp2 on CPU ranks
    rc = get_config("gpt-800m").reduced(dtype="float32",
                                        param_dtype="float32")
    dp1, _, _, _, _ = _dp_lm(one, rc, "fp32", 4, 64, 16, 3, overlap=False,
                             cpu_init=True)
    fp32 = ranks[0]["13b-fp32"]["losses"]
    _par(f"13b reduced fp32 {rc.name}: dp2 losses (fp32 buckets, overlap="
         f"{ranks[0]['13b-fp32']['overlap']}) {fp32}, dp1 {dp1}", card)
    np.testing.assert_allclose(fp32, dp1, rtol=1e-4)
    cpu = spawn(par_rank_int8, 2, device="cpu")
    flipped, total = 0, 0
    for r, c_ in zip(ranks, cpu):
        g, w = r["13b-int8"]["sync"][0], c_["sync"][0]
        diff = np.abs(g - w)
        assert (diff <= 2.5 * np.abs(w).max(-1, keepdims=True) + 1e-7).all(), \
            "an int8 code moved by more than one"
        flipped += int((diff > 1e-6).sum())
        total += diff.size
    _par(f"13b int8 dp2 card vs cpu ranks: losses {ranks[0]['13b-int8']['losses']}"
         f" vs {cpu[0]['losses']}, error-state codes flipped {flipped} of "
         f"{total}", card)
    assert flipped <= 1e-3 * total, (flipped, total)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        r1 = _dp_resnet(dev)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    r2 = ranks[0]["13b-resnet"]
    _par(f"13b reduced fp32 ResNet (TF32 off) dp2 with synced BatchNorm: "
         f"losses {r2}, dp1 {r1}", card)
    np.testing.assert_allclose(r2, r1, rtol=1e-4)
    # 13c: the pipeline
    t0 = time.perf_counter()
    pp = spawn(par_rank_pipeline, 4, device=dev, backend="gloo")
    t_pp = time.perf_counter() - t0
    err, ratio, share = pp[0]["gate"]
    steady = pp[0]["ms"][1:]
    _par(f"13c pipeline_gpt pp4 full gpt-117m, {PP_BATCH} x 64 tokens in 8 "
         f"microbatches: vs the sequential forward max_err={err:.3e} "
         f"max_err_ratio={ratio:.3e} (bf16 tol {TOL[torch.bfloat16]:.3e}) "
         f"mismatch_share={share:.3e}; bubble_fraction {pp[0]['bubble']:.4f}"
         f"; ms a forward {[round(x, 1) for x in pp[0]['ms']]} (steady mean "
         f"{sum(steady) / len(steady):.1f})", card)
    assert pp[0]["bubble"] == 3 / 11
    log(f"[wall] phase 13 {time.perf_counter() - t_start:.1f} s (13a+13b "
        f"ranks {t_dp:.1f} s, 13c ranks {t_pp:.1f} s)")


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
    if "--families" in sys.argv[1:]:
        _build.load_library()
        phase_families(dev, profile="--profile" in sys.argv[1:])
        log(f"[wall] phase 9 alone, the kernels' build included "
            f"{time.perf_counter() - t_start:.1f} s")
        print(card_line(), flush=True)
        return 0
    if "--generate" in sys.argv[1:]:
        _build.load_library()
        phase_generate(dev, profile="--profile" in sys.argv[1:])
        log(f"[wall] phase 10 alone, the kernels' build included "
            f"{time.perf_counter() - t_start:.1f} s")
        print(card_line(), flush=True)
        return 0
    if "--harness" in sys.argv[1:]:
        phase_harness(dev, profile="--profile" in sys.argv[1:])
        log(f"[wall] phase 11 alone {time.perf_counter() - t_start:.1f} s")
        print(card_line(), flush=True)
        return 0
    if "--dryrun" in sys.argv[1:]:
        check_grouped_decode(dev)
        phase_dryrun(dev)
        log(f"[wall] phase 12 alone {time.perf_counter() - t_start:.1f} s")
        print(card_line(), flush=True)
        return 0
    if "--parallel" in sys.argv[1:]:
        phase_parallel(dev)
        log(f"[wall] phase 13 alone {time.perf_counter() - t_start:.1f} s")
        print(card_line(), flush=True)
        return 0
    if "--train" in sys.argv[1:]:
        phase_train(dev, profile="--profile" in sys.argv[1:])
        phase_resnet(dev, profile="--profile" in sys.argv[1:])
        log(f"[wall] phases 7 and 8 alone "
            f"{time.perf_counter() - t_start:.1f} s")
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
    phase_workloads(dev, profile="--profile" in sys.argv[1:])
    phase_train(dev, profile="--profile" in sys.argv[1:])
    phase_resnet(dev, profile="--profile" in sys.argv[1:])
    family_errs = phase_families(dev, profile="--profile" in sys.argv[1:])
    gen_counts, gen_errs = phase_generate(dev,
                                          profile="--profile" in sys.argv[1:])
    phase_harness(dev, profile="--profile" in sys.argv[1:])
    phase_dryrun(dev)
    phase_parallel(dev)
    for row in rows:               # the worst over phases 1, 9 and 10
        row["max_abs_err"] = max(row["max_abs_err"],
                                 family_errs.get(row["name"], 0.0),
                                 gen_errs.get(row["name"], 0.0))
        # the main path's launches: phases 2, 2b, 4 and 10d
        row["launches"] += gen_counts.get(row["name"], 0)
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
