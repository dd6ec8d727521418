"""The general traffic generator: one batch a step, on the card, from
``--seed`` and the traffic file's parameters.

Copies of the port's ``data.synthetic`` generators, made on the device:

  * ``lm_tokens``: ``synthetic_tokens``' stream, ``Zipf(a) mod vocab``
    (numpy's ``zipf``, support ``k >= 1``), ``rows x (seq_len + 1)``
    draws a step, tokens the first ``seq_len`` columns and labels the
    last ``seq_len``. numpy draws Zipf by rejection on the host; here
    the folded distribution ``P(t) ~ sum_{k = t mod V} k^-a`` is
    computed once (Hurwitz zeta) and sampled with ``torch.multinomial``;
  * ``images``: ``synthetic_images``' uniform [0, 1) NHWC float32 images
    and uniform labels.

Every step draws fresh rows from one ``torch.Generator`` on the card,
so the same seed gives the same batches in the same order.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch


def seed_for(seed: int, stream: str) -> int:
    """A 63-bit generator seed from ``--seed`` (any whole number) and a
    stream name, so that weights and batches draw apart."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def zipf_mod_pmf(a: float, vocab: int) -> np.ndarray:
    """``P(Zipf(a) mod vocab = t)`` for ``t`` in ``[0, vocab)`` (float64):
    ``vocab^-a zeta(a, t / vocab)`` for ``t >= 1`` and
    ``vocab^-a zeta(a)`` for ``t = 0``, over ``zeta(a)``."""
    from scipy.special import zeta
    q = np.arange(vocab, dtype=np.float64) / vocab
    q[0] = 1.0
    w = zeta(a, q) * float(vocab) ** -a
    return w / w.sum()


class Feed:
    """``next()`` -> the next step's batch (a dict of device tensors)."""

    def __init__(self, traffic: dict, config: dict, seed: int, device):
        self.t, self.c = traffic, config
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(
            seed_for(seed, "traffic"))
        self.kind = traffic["kind"]
        if self.kind == "lm_tokens":
            pmf = zipf_mod_pmf(traffic["zipf_a"], config["vocab"])
            self.pmf = torch.as_tensor(pmf, dtype=torch.float32,
                                       device=self.device)
        elif self.kind != "images":
            raise ValueError(f"traffic kind {self.kind!r}: lm_tokens or "
                             "images")

    @property
    def rows(self) -> int:
        return int(self.t["global_batch"])

    def items_per_step(self) -> int:
        """Tokens (``lm_tokens``) or images (``images``) a step trains."""
        if self.kind == "lm_tokens":
            return self.rows * int(self.t["seq_len"])
        return self.rows

    def next(self) -> dict:
        if self.kind == "lm_tokens":
            s = int(self.t["seq_len"])
            z = torch.multinomial(self.pmf, self.rows * (s + 1),
                                  replacement=True, generator=self.gen)
            z = z.view(self.rows, s + 1).to(torch.int32)
            return {"tokens": z[:, :s].contiguous(),
                    "labels": z[:, 1:].contiguous()}
        n, size = self.rows, int(self.c["img_size"])
        images = torch.rand((n, size, size, 3), generator=self.gen,
                            device=self.device, dtype=torch.float32)
        labels = torch.randint(0, int(self.c["n_classes"]), (n,),
                               generator=self.gen, device=self.device,
                               dtype=torch.int64)
        return {"images": images, "labels": labels}
