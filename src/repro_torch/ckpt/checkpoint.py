"""Checkpointing: atomic, async, digest-verified.

Port of ``src/repro/ckpt/checkpoint.py``, same on-disk format, so either
package restores the other's checkpoints:

  - every leaf is one ``.npy`` file (bf16 leaves as their uint16 bit
    pattern, the logical dtype in the manifest), and a JSON
    manifest records each leaf's key (its tree path joined by ``/``,
    as the reference's ``tree_flatten_with_path`` spells it), file,
    shape, dtype and sha1 digest, and the step;
  - writes go to ``step_N.tmp/``, each file is fsynced, then
    ``os.replace`` publishes ``step_N/`` (atomicity) and the parent
    directory is fsynced;
  - ``verify_step`` / ``latest_valid_step`` / ``restore_resilient`` skip
    a step whose files fail their digests (in a rank world the writer
    alone reads the directory and broadcasts the step, so every rank
    resumes at the same one: ``resume_point``);
  - ``CheckpointManager.save_async`` snapshots the tree to host memory
    before it returns, and writes in a background thread.

The snapshot is where the port differs. The reference's ``np.asarray``
of a jax array is safe to write later because jax arrays are immutable;
a torch tensor is not: on the CPU ``.numpy()`` aliases the live tensor,
which the next in-place optimizer step changes, and on the card a copy
must be complete before the host reads it. So the snapshot is an owned
host copy of every leaf (``.to("cpu", copy=True)``, which waits for the
copy), taken before ``save_async`` returns. ``restore`` places leaves
into the template's dtypes and devices. In the place of the reference's
``shardings`` (elastic resharding on restore) a sharded world passes
``dp`` (``parallel.sharding.DpCheckpoint``): on save every rank gathers
its param shards and ZeRO-1 slices into whole leaves, the reference's
layout, and rank 0 alone writes; on restore every rank reads the whole
leaves and cuts its own shards and slices, for whatever plan restores
(a dp2tp2 checkpoint restores into tp2 or one device).
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import tree as tree_util

Params = Any
_SEP = "/"


def _fsync_dir(path) -> None:
    """fsync a directory so its entries (renames, new files) are durable."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds; best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _key(path: tuple) -> str:
    return _SEP.join(str(k) for k in path)


def _digest(arr: np.ndarray) -> str:
    """sha1 of the array's bytes in C order (the reference hashes
    ``tobytes()``; hashing the buffer gives the same digest without a
    copy)."""
    return hashlib.sha1(np.ascontiguousarray(arr)).hexdigest()[:16]


def _host(leaf: torch.Tensor) -> tuple:
    """``(data, logical dtype)``: an owned host copy of one leaf, in the
    form it is written (bf16 as its uint16 bit pattern, which numpy can
    hold)."""
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def snapshot(tree) -> dict[str, tuple]:
    """key -> ``(data, logical dtype)`` for every leaf: owned host
    copies, complete when this returns."""
    return {_key(path): _host(leaf) for path, leaf in tree_util.paths(tree)}


def _write(flat: dict, out_dir, step: int, extra_meta: Optional[dict]) -> str:
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / f"step_{step}.tmp"
    final = out / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "leaves": {}, "meta": extra_meta or {}}
    for i, (key, (data, logical)) in enumerate(sorted(flat.items())):
        fn = f"leaf_{i:05d}.npy"
        with open(tmp / fn, "wb") as f:
            np.save(f, data)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"][key] = {
            "file": fn, "shape": list(data.shape), "dtype": logical,
            "sha1": _digest(data)}
    with open(tmp / "manifest.json", "w") as f:
        f.write(json.dumps(manifest, indent=1))
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish
    _fsync_dir(out)         # make the rename itself durable
    return str(final)


def save(tree, out_dir, step: int, extra_meta: Optional[dict] = None) -> str:
    return _write(snapshot(tree), out_dir, step, extra_meta)


def _all_steps(out_dir) -> list[int]:
    out = pathlib.Path(out_dir)
    if not out.exists():
        return []
    return sorted(int(m.group(1)) for p in out.iterdir()
                  if (m := re.fullmatch(r"step_(\d+)", p.name)))


def latest_step(out_dir) -> Optional[int]:
    steps = _all_steps(out_dir)
    return steps[-1] if steps else None


def verify_step(out_dir, step: int) -> bool:
    """True iff ``step_N/`` is a complete, uncorrupted checkpoint:
    parseable manifest, every leaf file present, and (when the manifest
    carries digests) per-leaf sha1 matching the bytes on disk."""
    d = pathlib.Path(out_dir) / f"step_{step}"
    try:
        manifest = json.loads((d / "manifest.json").read_text())
        for v in manifest["leaves"].values():
            arr = np.load(d / v["file"])
            if list(arr.shape) != list(v["shape"]):
                return False  # same-width uint views preserve shape
            want = v.get("sha1")
            if want is not None and _digest(arr) != want:
                return False
    except (OSError, ValueError, KeyError, json.JSONDecodeError):
        return False
    return True


def latest_valid_step(out_dir) -> Optional[int]:
    """Newest step that passes :func:`verify_step` (corruption-aware
    variant of :func:`latest_step`)."""
    for s in reversed(_all_steps(out_dir)):
        if verify_step(out_dir, s):
            return s
    return None


def _shared(dp, read):
    """``read()`` on this process, or, in a rank world (``dp``: a
    ``writer`` flag and a ``broadcast`` of the writer's object), the
    writer's ``read()`` on every rank: all ranks resume at one step."""
    if dp is None:
        return read()
    return dp.broadcast(read() if dp.writer else None)


def resume_point(out_dir, dp=None) -> tuple:
    """``(latest_step, latest_valid_step)`` of ``out_dir``, read by the
    writer alone in a rank world (see :func:`_shared`)."""
    return _shared(dp, lambda: (latest_step(out_dir),
                                latest_valid_step(out_dir)))


def restore_resilient(template, out_dir, dp=None):
    """Restore the newest *valid* checkpoint, skipping corrupted or
    partial steps (falls back to the previous atomic step).

    Returns ``(tree, manifest, skipped)`` where ``skipped`` lists the
    step numbers that failed verification, newest first. In a rank world
    the writer verifies and every rank restores the step it names.
    """
    def newest_valid():
        skipped: list[int] = []
        for s in reversed(_all_steps(out_dir)):
            if verify_step(out_dir, s):
                return s, skipped
            skipped.append(s)
        return None, skipped

    step, skipped = _shared(dp, newest_valid)
    if step is None:
        raise FileNotFoundError(
            f"no valid checkpoints in {out_dir}"
            + (f" (corrupted: {skipped})" if skipped else ""))
    tree, manifest = restore(template, out_dir, step=step, dp=dp)
    return tree, manifest, skipped


def _load(path: pathlib.Path, logical: str) -> torch.Tensor:
    arr = np.load(path)
    if logical == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(template, out_dir, step: Optional[int] = None, dp=None):
    """Restore into the structure of ``template``: each leaf a new tensor
    with the template leaf's dtype, on its device (whole leaves, cut to
    this rank's slices by ``dp`` when given). Returns
    ``(tree, manifest)``."""
    if step is None:
        step = latest_step(out_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {out_dir}")
    d = pathlib.Path(out_dir) / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    entries = manifest["leaves"]
    leaves = []
    for path, leaf in tree_util.paths(template):
        v = entries[_key(path)]
        t = _load(d / v["file"], v["dtype"])
        leaves.append(t.to(device=leaf.device, dtype=leaf.dtype))
    tree = tree_util.unflatten(template, leaves)
    return (tree if dp is None else dp.local(tree)), manifest


class CheckpointManager:
    """Async, retention-managed checkpointing for the training loop."""

    def __init__(self, out_dir, keep: int = 3, dp=None):
        self.out_dir = pathlib.Path(out_dir)
        self.keep = keep
        #: a dp world's gather-then-rank-0-writes rule (DpCheckpoint)
        self.dp = dp
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        self.last_saved: Optional[int] = None

    def _mine(self, tree):
        """``tree`` whole, or None on a rank that does not write."""
        if self.dp is None:
            return tree
        tree = self.dp.whole(tree)          # collective
        return tree if self.dp.writer else None

    def save_async(self, tree, step: int, extra_meta: Optional[dict] = None):
        self.wait()  # one in-flight save at a time (re-raises prior failure)
        tree = self._mine(tree)
        if tree is None:
            return
        flat = snapshot(tree)  # owned host copies, before returning

        def work():
            try:
                _write(flat, self.out_dir, step, extra_meta)
                self.last_saved = step
                self._gc()
            except BaseException as e:  # surfaced at wait()/next save
                self._exc = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save_sync(self, tree, step: int, extra_meta: Optional[dict] = None):
        self.wait()
        mine = self._mine(tree)
        if mine is not None:
            save(mine, self.out_dir, step, extra_meta)
            self.last_saved = step
            self._gc()
        if self.dp is not None:
            self.dp.barrier()   # every rank returns once the step is written

    def wait(self):
        """Join any in-flight save; re-raise an exception it captured
        (a failed background save must not be silently dropped)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def _gc(self):
        for s in _all_steps(self.out_dir)[:-self.keep]:
            shutil.rmtree(self.out_dir / f"step_{s}", ignore_errors=True)
