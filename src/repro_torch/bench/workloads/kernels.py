"""Kernel microbenchmarks: the port's CUDA kernels vs their plain versions.

Port of ``src/repro/bench/workloads/kernels.py``. Axes ``case x impl``:
``plain`` calls the ``kernels/ref.py`` function directly, ``cuda`` calls
``kernels.ops`` — the hand-written kernel on the card (on the CPU,
``--device cpu``, ops dispatches to the plain version, so both rows time
the same code). ``us`` is wall time per call between two
``torch.cuda.synchronize`` calls, launch included, over at least
``MIN_ITERS`` back-to-back calls (the reference took 3, timing its
interpret mode). The reference's ``interpret`` column has no meaning on
CUDA and is dropped. ``cuda`` rows carry ``max_err``: the largest
|kernel - plain| against the plain version run in fp32 on the inputs
upcast (int8 codes pass unchanged) and cast back to the kernel's type,
beside ``max_err_ratio`` = max |err| / (1 + |plain|) and the share of
outputs that differ at all (``mismatch_share``). Power measurement is
off: kernels this short are far below the sampling interval.

Cases: the reference's five, with its exact shapes in fp32 (cut for CPU
interpret mode, its own comment says), and four at llama3.2-3b's full
width in bf16 (H=24, Kh=8, Dh=128, d_model 3072): a 2048-token causal
prefill for flash attention, 4096 rows of RMSNorm, and the serve run's
prefix-hit prefill (B=8, Sq=128, 16 prefix blocks of 16, the last row a
pad row on the trash block 0), on an fp and an int8 pool. The full-width
cases stay out of the ``smoke`` preset. Inputs come from
``numpy.random.default_rng`` with fixed seeds.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.spec import workload
from repro_torch.core.params import Space
from repro_torch.kernels import ops, ref

MIN_ITERS = 50

FLASH_SHAPES = {
    # case -> (batch, seq, heads, kv_heads, d_head, dtype)
    "flash_b1_s256": (1, 256, 4, 2, 64, torch.float32),
    "flash_b2_s512": (2, 512, 8, 8, 64, torch.float32),
    "flash_llama3b_b2_s2048": (2, 2048, 24, 8, 128, torch.bfloat16),
}

RMSNORM_SHAPES = {
    # case -> (rows, d, dtype)
    "rmsnorm": (512, 1024, torch.float32),
    "rmsnorm_llama3b_t4096": (4096, 3072, torch.bfloat16),
}

#: paged prefill cases: the reference's 32-token chunk against 3 prefix
#: blocks per row (GQA 4q/2kv), and the serve run's prefix-hit shape at
#: full width; ``pad_row`` points the last row at the trash block 0, as
#: the serve engine pads its prefill groups
PAGED_PREFILL_SHAPES = {
    "paged_prefill": dict(b=2, sq=32, h=4, kh=2, dh=16, bs=16, npre=3,
                          n_blocks=8, dtype=torch.float32, pad_row=False),
    "paged_prefill_llama3b": dict(b=8, sq=128, h=24, kh=8, dh=128, bs=16,
                                  npre=16, n_blocks=1 + 8 * 16 + 4,
                                  dtype=torch.bfloat16, pad_row=True),
}

CASES = ["flash_b1_s256", "flash_b2_s512", "rmsnorm", "paged_prefill",
         "paged_prefill_int8", "flash_llama3b_b2_s2048",
         "rmsnorm_llama3b_t4096", "paged_prefill_llama3b",
         "paged_prefill_int8_llama3b"]


def quantize(pool: torch.Tensor):
    """Symmetric int8 codes and per-(block, KV-head) fp32 scales of an
    fp32 pool (the reference's quantiser, ``kernels.py:57-61``)."""
    sc = pool.abs().amax(dim=(1, 3)) / 127.0
    sc = torch.where(sc > 0, sc, torch.ones_like(sc))
    codes = torch.round(pool / sc[:, None, :, None]).clamp(-127, 127)
    return codes.to(torch.int8), sc


def _normal(rng, shape, dtype, device) -> torch.Tensor:
    a = rng.standard_normal(size=shape, dtype=np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _flash_inputs(case: str, device):
    b, s, h, kh, dh, dtype = FLASH_SHAPES[case]
    rng = np.random.default_rng(0)
    return ((_normal(rng, (b, s, h, dh), dtype, device),
             _normal(rng, (b, s, kh, dh), dtype, device),
             _normal(rng, (b, s, kh, dh), dtype, device)), {})


def _rmsnorm_inputs(case: str, device):
    rows, d, dtype = RMSNORM_SHAPES[case]
    rng = np.random.default_rng(0)
    x = _normal(rng, (rows, d), dtype, device)
    if case == "rmsnorm":                   # the reference's unit scale
        scale = torch.ones(d, dtype=dtype, device=device)
    else:
        scale = _normal(rng, (d,), dtype, device)
    return (x, scale), {}


def _paged_prefill_inputs(case: str, device):
    """(q, k_suffix, v_suffix, k_pool, v_pool, tables) and, for an int8
    case, the pools' scales, with shuffled block tables (block 0 left to
    the trash block's role)."""
    quantized = "_int8" in case
    p = PAGED_PREFILL_SHAPES[case.replace("_int8", "")]
    b, sq, h, kh, dh = p["b"], p["sq"], p["h"], p["kh"], p["dh"]
    bs, npre, nblk, dtype = p["bs"], p["npre"], p["n_blocks"], p["dtype"]
    rng = np.random.default_rng(1)
    q = _normal(rng, (b, sq, h, dh), dtype, device)
    k_suf = _normal(rng, (b, sq, kh, dh), dtype, device)
    v_suf = _normal(rng, (b, sq, kh, dh), dtype, device)
    pool_dtype = torch.float32 if quantized else dtype
    k_pool = _normal(rng, (nblk, bs, kh, dh), pool_dtype, device)
    v_pool = _normal(rng, (nblk, bs, kh, dh), pool_dtype, device)
    tables = rng.permutation(np.arange(1, nblk))[:b * npre]
    tables = tables.reshape(b, npre).astype(np.int32)
    if p["pad_row"]:
        tables[-1] = 0
    tables = torch.from_numpy(tables).to(device)
    kw = {}
    if quantized:
        k_pool, kw["k_scale"] = quantize(k_pool)
        v_pool, kw["v_scale"] = quantize(v_pool)
    return (q, k_suf, v_suf, k_pool, v_pool, tables), kw


def case_inputs(case: str, device):
    """(plain version, ops function, args, kwargs) of one case."""
    if case.startswith("flash"):
        return (ref.flash_attention_ref, ops.flash_attention,
                *_flash_inputs(case, device))
    if case.startswith("rmsnorm"):
        return (ref.rmsnorm_ref, ops.rmsnorm, *_rmsnorm_inputs(case, device))
    return (ref.paged_prefill_attention_ref, ops.paged_prefill_attention,
            *_paged_prefill_inputs(case, device))


def plain_fp32(fn, *args, **kw) -> torch.Tensor:
    """The plain version on the floating-point inputs upcast to fp32 (int8
    codes and int32 tables pass unchanged), its result cast back to the
    first input's type: what the kernels compute, rounded once."""
    up = lambda a: a.float() if torch.is_tensor(a) and \
        a.is_floating_point() else a
    return fn(*map(up, args), **{k: up(v) for k, v in kw.items()}).to(
        args[0].dtype)


def error_metrics(got: torch.Tensor, want: torch.Tensor) -> dict:
    diff = (got.float() - want.float()).abs()
    return {"max_err": diff.max().item(),
            "max_err_ratio": (diff / (1 + want.float().abs())).max().item(),
            "mismatch_share": (diff > 0).float().mean().item()}


@workload(
    "kernels",
    analog="CUDA kernel microbench (flash attention, rmsnorm, paged "
           "prefill fp / int8) against the plain PyTorch versions",
    space=Space({"case": CASES, "impl": ["plain", "cuda"]}),
    smoke={"case": ["flash_b1_s256", "rmsnorm", "paged_prefill",
                    "paged_prefill_int8"]},
    tags=("kernels", "smoke", "full"),
    result_columns=["case", "impl", "us", "max_err"],
    primary_metric="us",
)
def build(pt, ctx):
    """Kernel-vs-plain timing sweep."""
    case, impl = pt["case"], pt["impl"]
    plain, op, args, kw = ctx.memo(("kernels", case),
                                   lambda: case_inputs(case, ctx.device))
    fn = op if impl == "cuda" else plain

    def run():
        m = ctx.measure(fn, *args, iters=max(ctx.iters, MIN_ITERS),
                        power=False, **kw)
        out = {"us": m.us, "seconds": m.seconds,
               "dtype": str(args[0].dtype).removeprefix("torch.")}
        if impl == "cuda":
            got = fn(*args, **kw)
            out.update(error_metrics(got, plain_fp32(plain, *args, **kw)))
        return out

    return {"run": run}
