"""Build and load the port's CUDA kernels.

Every ``src/repro_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) — one ``nvcc`` process per source, all started together —
and linked into one shared library with a plain C interface under
``build/repro_torch/`` at the repository root, named by a hash of the
sources and flags (an edited source rebuilds, an unchanged one loads).
The library is loaded with ``ctypes``; each C function returns the
``cudaGetLastError()`` of its launch, which the Python wrappers turn
into an exception.

Nothing is built at import time: :func:`load_library` builds on first
use. A file lock serialises concurrent builds.

:class:`StreamState` is what a wrapper keeps per (card, stream) for
kernels that merge partials across blocks: ticket counters and scratch.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: element-type codes of the C interface (``csrc/common.cuh``): the
#: kernels take fp32 and bf16 tensors, and int8 KV pool codes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
INT8_CODE = 2

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
#: C signatures: pointers and the stream as void*, sizes as int, strides
#: as long long
SIGNATURES = {
    # q, k_pool, v_pool, tables, lengths, out, k_scale, v_scale,
    # scratch, tickets, batch, kv_heads, group, d_head, block_size,
    # n_table_cols, table_stride, window, splits, chunk, scale, dtype,
    # pool_dtype, stream
    "repro_paged_decode_attention":
        [_P] * 10 + [_I] * 10 + [_F, _I, _I, _P],
    # q, k_suffix, v_suffix, k_pool, v_pool, tables, out, k_scale,
    # v_scale, batch, sq, kv_heads, group, d_head, block_size, npre,
    # table_stride, window, scale, dtype, pool_dtype, stream
    "repro_paged_prefill_attention":
        [_P] * 9 + [_I] * 9 + [_F, _I, _I, _P],
    # q, k, v, out, batch, sq, skv, heads, kv_heads, d_head,
    # q/k/v strides over (batch, seq, head), causal, window, scale,
    # dtype, stream
    "repro_flash_attention":
        [_P] * 4 + [_I] * 6 + [_L] * 9 + [_I, _I, _F, _I, _P],
    # x, scale, out, rows, d, grid, eps, dtype, scale_dtype, vector,
    # stream
    "repro_rmsnorm": [_P] * 3 + [_I] * 3 + [_F, _I, _I, _I, _P],
    # out: chunk, table sizes, struct sizes
    "repro_adamw_layout": [_P],
    # leaves, n_leaves, n_items, partials, stream
    "repro_adamw_norm": [_P, _I, _I, _P, _P],
    # partials, n, clip, stats, stream
    "repro_adamw_finalize": [_P, _I, _F, _P, _P],
    # leaves, n_leaves, n_items, stats, lr, bc1, bc2, b1, b2, 1 - b1,
    # 1 - b2, eps, weight decay, stream
    "repro_adamw_update": [_P, _I, _I] + [_P] * 4 + [_F] * 6 + [_P],
    # act, dtype, param dtype, out: resident blocks an SM of each kernel
    "repro_batchnorm_occupancy": [_I, _I, _I, _P],
    # x, sc, scale, bias, y, stats, part, tickets, M, C, then chunks and
    # rows a chunk of the statistics and of the apply, eps, act, dtype,
    # param dtype, stream
    "repro_batchnorm_forward": [_P] * 8 + [_I] * 6 + [_F, _I, _I, _I, _P],
    # dy, x, out, scale, bias, stats, dx, dsc, dparams, coef, part,
    # tickets, M, C, the two plans as above, act, dtype, param dtype,
    # stream
    "repro_batchnorm_backward": [_P] * 12 + [_I] * 9 + [_P],
    "repro_cuda_error_string": [_I],
}


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(SRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def build() -> Path:
    """Compile and link the library unless this source hash is built."""
    digest = _digest()
    so = BUILD_DIR / f"librepro_torch_{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so
        nvcc = find_nvcc()
        jobs = []
        for src in sorted(SRC_DIR.glob("*.cu")):
            obj = BUILD_DIR / f"{src.stem}_{digest}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _obj, proc in jobs:
            out, _ = proc.communicate()
            log.append(f"== nvcc {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode:
                failed.append(src.name)
        (BUILD_DIR / "build.log").write_text("".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "".join(log))
        tmp = so.with_name(so.name + ".tmp")
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp, so)
    return so


def build_log() -> str:
    path = BUILD_DIR / "build.log"
    return path.read_text() if path.exists() else ""


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_char_p if name == "repro_cuda_error_string" \
            else ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of card ``index`` (read once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err:
        msg = load_library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


class StreamState:
    """What a kernel's wrapper keeps per (card, stream), so that a call
    pays for none of it: the SM count, launch plans (``plans``, the
    wrapper's to fill), the tickets (int32 counters that the kernels
    leave at zero) and the partials' scratch (fp32, written before it is
    read in every launch, so never cleared), both grown on demand.
    Launches on one stream run one after another, so they may share
    these; launches on two streams may run at once, so each stream has
    its own. A graph captured on a stream uses that stream's buffers: do
    not replay it beside calls on that stream. Buffers that were
    outgrown stay allocated, since a captured graph may still name
    them."""

    def __init__(self, kernel: str, device: torch.device, tickets: int):
        self.kernel = kernel
        self.device = device
        self.sms = sm_count(device.index)
        self.plans: dict = {}
        self.tickets = torch.zeros(tickets, dtype=torch.int32, device=device)
        self.scratch = torch.empty(0, dtype=torch.float32, device=device)
        self.outgrown: list = []

    def tickets_ptr(self, n: int) -> int:
        """The address of at least ``n`` zeroed tickets."""
        if n > self.tickets.numel():
            refuse_in_capture(self.kernel, f"{n} ticket counters (this "
                              f"stream has {self.tickets.numel()})")
            self.outgrown.append(self.tickets)
            self.tickets = torch.zeros(2 * n, dtype=torch.int32,
                                       device=self.device)
        return self.tickets.data_ptr()

    def scratch_ptr(self, n: int) -> int:
        """The address of at least ``n`` floats of scratch."""
        if n > self.scratch.numel():
            self.outgrown.append(self.scratch)
            self.scratch = torch.empty(2 * n, dtype=torch.float32,
                                       device=self.device)
        return self.scratch.data_ptr()


def refuse_in_capture(kernel: str, what: str) -> None:
    """Ticket counters must be zeroed outside a CUDA graph: zeroed inside
    one they would hold garbage until its first replay."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{kernel} needs {what} while the stream is capturing a CUDA "
            f"graph; call it once with these shapes on the capture stream "
            f"before capturing")


def stream_state(states: dict, kernel: str, device: torch.device,
                 stream: int, tickets: int) -> StreamState:
    """``kernel``'s state on (``device``, ``stream``) in ``states``, made
    on the stream's first call with ``tickets`` counters."""
    state = states.get((device.index, stream))
    if state is None:
        refuse_in_capture(kernel, "its first call on this stream")
        state = states[device.index, stream] = StreamState(kernel, device,
                                                           tickets)
    return state
