"""Pipeline parallelism across ranks: the rotation schedule.

Port of ``src/repro/parallel/pipeline.py``. The paper's Graphcore case
trains GPT-117M with its layers pipelined over 4 IPUs; the reference
maps the pattern onto a mesh ``stage`` axis inside ``shard_map``, with a
``collective_permute`` handing activations on each tick. In the port a
stage is a rank of the mesh's ``stage`` group:

  * **Schedule.** At tick ``t`` stage ``s`` holds microbatch ``t - s``;
    there are ``n_mb + n_stages - 1`` ticks. Stage 0 reads microbatch
    ``t``, every other stage receives its input from stage ``s - 1``
    (``recv``) and hands its output to stage ``s + 1`` (``isend``).
  * **The bubble.** The reference computes every stage on every tick
    and discards the ticks without a microbatch (``where``); a stage here
    skips its layers on those ticks and waits on the ``recv`` instead, so
    outputs are equal and the wait stands in for the bubble
    (:func:`bubble_fraction`).
  * **Hand-off.** ``gloo`` sends host tensors only, so on a gloo group
    an activation on the card is staged through pinned host memory on
    both sides; the copy is chosen by the group's backend, never as a
    fallback on error.
  * **Outputs** are broadcast from the last stage, as the reference's
    closing ``psum`` of the last stage's buffer does.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.core import tree

Params = Any


def stage_params_split(params_stacked, n_stages: int):
    """Split stacked layer params (L, ...) into (n_stages, L/S, ...)."""
    def split(x):
        n = x.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers do not split into {n_stages} "
                             f"stages")
        return x.reshape(n_stages, n // n_stages, *x.shape[1:])
    return tree.tree_map(split, params_stacked)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """The pipeline-bubble overhead the paper cites for the IPU case."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


class _Link:
    """Point-to-point activations between two stages, staged through a
    pinned host buffer when the group's backend is gloo and the tensors
    live on the card."""

    def __init__(self, shape, dtype, device, group):
        self.device = device
        staged = (device.type == "cuda"
                  and dist.get_backend(group) == dist.Backend.GLOO)
        self.host = (torch.empty(shape, dtype=dtype, pin_memory=True)
                     if staged else None)
        self.pending = None

    def send(self, y: torch.Tensor, dst: int, group) -> None:
        self.wait()
        if self.host is not None:
            self.host.copy_(y)          # waits for the card's queue
            y = self.host
        else:
            y = y.contiguous()
        self.pending = (dist.isend(y, dst, group=group), y)

    def recv(self, shape, dtype, src: int, group) -> torch.Tensor:
        if self.host is not None:
            dist.recv(self.host, src, group=group)
            return self.host.to(self.device, non_blocking=False)
        x = torch.empty(shape, dtype=dtype, device=self.device)
        dist.recv(x, src, group=group)
        return x

    def wait(self) -> None:
        if self.pending is not None:
            self.pending[0].wait()
            self.pending = None


def pipeline_forward(mesh, stage_axis: str, layer_fn: Callable,
                     stage_params, x_microbatches: torch.Tensor):
    """Run microbatches through pipeline stages.

    ``layer_fn(params_for_stage, x) -> x`` is applied per stage;
    ``stage_params`` has a leading dim of ``n_stages`` (this rank uses
    its stage's slice); ``x_microbatches`` (n_mb, mb, S, D) is every
    rank's copy of the inputs. Returns the (n_mb, mb, S, D) outputs on
    every rank."""
    group = mesh.group(stage_axis)
    ranks = mesh.ranks(stage_axis)
    n_stages = len(ranks)
    stage = mesh.index(stage_axis)
    n_mb = x_microbatches.shape[0]
    mb_shape = tuple(x_microbatches.shape[1:])
    dtype, dev = x_microbatches.dtype, x_microbatches.device
    params = tree.tree_map(lambda p: p[stage], stage_params)
    outs = torch.zeros((n_mb, *mb_shape), dtype=dtype, device=dev)
    if n_stages == 1:
        for i in range(n_mb):
            outs[i] = layer_fn(params, x_microbatches[i])
        return outs
    link_in = _Link(mb_shape, dtype, dev, group)
    link_out = _Link(mb_shape, dtype, dev, group)
    last = n_stages - 1
    for t in range(n_mb + n_stages - 1):
        i = t - stage
        if not 0 <= i < n_mb:
            continue                    # the bubble: no microbatch here
        if stage == 0:
            x = x_microbatches[i]
        else:
            x = link_in.recv(mb_shape, dtype, ranks[stage - 1], group)
        y = layer_fn(params, x)
        if stage == last:
            outs[i] = y
        else:
            link_out.send(y, ranks[stage + 1], group)
    link_out.wait()
    dist.broadcast(outs, ranks[last], group=group)
    return outs
