"""Weights from the seed: one draw on the card into one flat buffer.

A model kind lists its leaves as ``(name, shape, mean, std)``; the
name is the leaf's path in the port's tree, joined by dots (list
indices as numbers). :func:`make` draws every leaf at once with one
``torch.randn`` in the served dtype from a generator on the device,
then moves each leaf's slice to its mean and spread in place; each leaf
starts on a 256-byte boundary. The same seed on the same device gives
the same bits, so the reference regenerates the weights instead of
taking anything from the program.
"""
from __future__ import annotations

from math import prod

import torch

from cbench.traffic import seed_for

ALIGN = 128          # elements: 256 bytes of bf16


def _offsets(specs) -> tuple[list[int], int]:
    offs, total = [], 0
    for _name, shape, _m, _s in specs:
        offs.append(total)
        total += -(-prod(shape) // ALIGN) * ALIGN
    return offs, total


def make(specs, seed: int, device, dtype=torch.bfloat16) -> dict:
    """``{name: tensor}``, views of one flat buffer of ``dtype``."""
    offs, total = _offsets(specs)
    gen = torch.Generator(device=device).manual_seed(seed_for(seed,
                                                              "weights"))
    buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out = {}
    for off, (name, shape, mean, std) in zip(offs, specs):
        leaf = buf[off:off + prod(shape)].view(shape)
        leaf.mul_(std)
        if mean:
            leaf.add_(mean)
        out[name] = leaf
    return out


def nest(named: dict):
    """The nested tree of ``named``'s dotted paths: dicts, with a run of
    numeric keys ``0..n-1`` made a list."""
    root: dict = {}
    for name, leaf in named.items():
        node = root
        *parents, last = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    kids = {k: _lists(v) for k, v in node.items()}
    if kids and all(k.isdigit() for k in kids):
        return [kids[str(i)] for i in range(len(kids))]
    return kids


def flat(tree, prefix: str = "") -> dict:
    """``{dotted path: leaf}`` of a nested tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}.{k}" if prefix else k))
    return out
