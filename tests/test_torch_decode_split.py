"""The split-KV paged decode kernel's arithmetic, emulated on the CPU,
against the plain version under the card's gate; and the host-side
split choice.

``csrc/paged_decode_attention.cu`` gives split s of a sequence the table
columns [s * chunk, (s + 1) * chunk) and, inside them, the visible keys
[kb, ke) (kb = max(s * chunk * bs, length - window), ke = min(split end,
length)). Key i of that range goes to warp (i // kR) % 4 and row group
i % kR of the warp, kR being the key rows a warp reads at once (32 over
the lanes one row's 16-byte vectors take). Each row group keeps an
online softmax in base 2 (scores q . k times scale * log2(e), int8 codes
times their block scale in fp32); the row groups of a warp merge, then
the warps in order, then the splits that hold visible keys in order
(the others exit without a partial): weights exp2(m - M), a partial
that saw no key (m = -inf) weighing 0, and out = acc / l (0 where l =
0). This file repeats that in torch (an empty split's partial weighing
0 stands for its absence) and holds it to
``kernels.ref.paged_decode_attention_ref`` (fp32: 1e-3; bf16: the plain
version in fp32 cast once, |err| <= 2**-7 * (1 + |want|) and at most 1 %
of outputs differing) over the edges the split adds: a one-token
sequence on a trash-only table, lengths at and one past a split
boundary, a window that hides whole splits, one sequence over many
splits, a table width that is not a multiple of the chunk, int8 pools,
G = 1, 2, 3 and the head widths 16, 96 and 128. Groups of 4, 7 and 8
heads run as head chunks of at most 3 on the card, each with the same
per-head arithmetic as here; ``tests/test_torch_cuda.py`` holds the
chunk indexing itself.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.bench.workloads.kernels import error_metrics, plain_fp32, \
    quantize
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import MAX_SPLITS, decode_splits

WARPS = 4                      # kWarps
LOG2E = 1.4426950408889634
SMS = 132                      # the H100's SMs
TOL = {torch.float32: 1e-3, torch.bfloat16: 2.0 ** -7}


def _rows_per_warp(dh: int, pool_itemsize: int) -> int:
    """kR: 32 over the lanes of one key row (its 16-byte vectors, rounded
    up to a power of two)."""
    vectors = dh * pool_itemsize // 16
    lanes = 1
    while lanes < vectors:
        lanes *= 2
    return 32 // lanes


def _merge(m, l, acc):
    """Merge the partials along the last dim of m/l (.., n) and acc
    (.., n, Dh): weights exp2(m - max), -inf partials weighing 0."""
    mx = m.amax(dim=-1, keepdim=True)
    f = torch.where(m == -math.inf, torch.zeros(()),
                    torch.exp2(m - torch.where(mx == -math.inf,
                                               torch.zeros(()), mx)))
    return (mx.squeeze(-1), (f * l).sum(-1),
            (f.unsqueeze(-1) * acc).sum(-2))


def split_decode_emulated(q, k_pool, v_pool, tables, lengths, *, splits,
                          chunk, window=None, k_scale=None, v_scale=None):
    """The kernel's partials and ordered combine; inputs as the kernel's
    (bf16 or fp32 q and pools, or int8 codes with fp32 scales)."""
    b, h, dh = q.shape
    nb = tables.shape[1]
    bs, kh = k_pool.shape[1], k_pool.shape[2]
    g = h // kh
    kr = _rows_per_warp(dh, k_pool.element_size())
    n_keys = nb * bs
    qs = q.float() * (torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)
                      * torch.tensor(LOG2E, dtype=torch.float32))
    k = ref.dequantize_pool(k_pool, tables, k_scale).reshape(b, n_keys, kh,
                                                             dh)
    v = ref.dequantize_pool(v_pool, tables, v_scale).reshape(b, n_keys, kh,
                                                             dh)
    s = torch.einsum("bkgd,btkd->bkgt", qs.reshape(b, kh, g, dh), k)
    kpos = torch.arange(n_keys)[None, :]
    lens = lengths.long()[:, None]
    lo = lens - 1 - window if window is not None and window > 0 \
        else torch.full_like(lens, -1)
    visible = (kpos < lens) & (kpos > lo)
    split = kpos // (chunk * bs)                              # (1, T)
    kb = torch.maximum(split * chunk * bs, lo + 1)            # (B, T)
    i = kpos - kb
    group = (split * WARPS + (i // kr) % WARPS) * kr + i % kr  # (B, T)
    group = torch.where(visible, group, torch.zeros_like(group))
    n_groups = splits * WARPS * kr
    s = s.masked_fill(~visible[:, None, None, :], -math.inf)
    idx = group[:, None, None, :].expand_as(s)
    m = torch.full((b, kh, g, n_groups), -math.inf).scatter_reduce(
        3, idx, s, "amax")
    m_key = m.gather(3, idx)
    p = torch.where(visible[:, None, None, :],
                    torch.exp2(s - torch.where(m_key == -math.inf,
                                               torch.zeros(()), m_key)),
                    torch.zeros(()))
    l = torch.zeros(b, kh, g, n_groups).scatter_add(3, idx, p)
    acc = torch.zeros(b, kh, g, n_groups, dh)
    pv = torch.einsum("bkgt,btkd->bkgtd", p, v)
    acc.scatter_add_(3, idx[..., None].expand_as(pv), pv)
    # row groups of a warp, the warps of a split, the splits: in order
    m = m.reshape(b, kh, g, splits, WARPS, kr)
    l = l.reshape(b, kh, g, splits, WARPS, kr)
    acc = acc.reshape(b, kh, g, splits, WARPS, kr, dh)
    for _ in range(3):
        m, l, acc = _merge(m, l, acc)
    out = torch.where(l[..., None] > 0, acc / l[..., None].clamp_min(1e-30),
                      torch.zeros(()))
    return out.reshape(b, h, dh).to(q.dtype)


def _case(rng, lengths, *, nb, bs=16, kh=2, g=3, dh=128, dtype, int8,
          trash_row=None):
    """Inputs whose tables own ceil(length / bs) blocks and point the rest
    at the trash block 0; ``trash_row`` names only block 0."""
    b = len(lengths)
    n_blocks = 1 + b * nb
    perm = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((b, nb), np.int32)
    for i, ln in enumerate(lengths):
        need = -(-int(ln) // bs)
        tables[i, :need] = perm[i * nb:i * nb + need]
    if trash_row is not None:
        tables[trash_row] = 0
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(size=s, dtype=np.float32))
    kp, vp = t(n_blocks, bs, kh, dh), t(n_blocks, bs, kh, dh)
    kw = {}
    if int8:
        kp, kw["k_scale"] = quantize(kp)
        vp, kw["v_scale"] = quantize(vp)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    return (t(b, kh * g, dh).to(dtype), kp, vp, torch.from_numpy(tables),
            torch.tensor(lengths, dtype=torch.int32)), kw


def _check(args, kw, dtype, *, splits, chunk, window=None):
    got = split_decode_emulated(*args, splits=splits, chunk=chunk,
                                window=window, **kw)
    want = plain_fp32(ref.paged_decode_attention_ref, *args, window=window,
                      **kw)
    m = error_metrics(got, want)
    assert m["max_err_ratio"] <= TOL[dtype], m
    if dtype == torch.bfloat16:
        assert m["mismatch_share"] <= 1e-2, m
    return got


BOUNDARY = 4 * 16                 # chunk 4 blocks of 16 keys


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("case", [
    # name: lengths, window, nb, explicit splits (else decode_splits)
    ("one token, trash table", [1, 200, 64, 17], None, 16, None),
    ("at and past a boundary", [BOUNDARY, BOUNDARY + 1, 2 * BOUNDARY,
                                2 * BOUNDARY + 1], None, 16, 4),
    ("window hides splits", [256, 250, 129, 65], 20, 16, 4),
    ("nb not a chunk multiple", [160, 33, 1, 97], None, 10, 4),
])
def test_split_decode_edges(dtype, int8, case):
    _, lengths, window, nb, splits = case
    rng = np.random.default_rng(len(lengths) + nb)
    args, kw = _case(rng, lengths, nb=nb, dtype=dtype, int8=int8,
                     trash_row=0 if lengths[0] == 1 else None)
    if splits is None:
        splits, chunk = decode_splits(len(lengths), 2, nb, SMS, group=3)
        assert splits > 1
    else:
        chunk = -(-nb // splits)
    got = _check(args, kw, dtype, splits=splits, chunk=chunk, window=window)
    if lengths[0] == 1:          # the trash-only row sees its one key
        assert torch.isfinite(got[0].float()).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
def test_split_decode_one_sequence_many_splits(dtype, int8):
    rng = np.random.default_rng(5)
    splits, chunk = decode_splits(1, 2, 64, SMS, group=3)
    assert (splits, chunk) == (64, 1)
    args, kw = _case(rng, [1000], nb=64, dtype=dtype, int8=int8)
    _check(args, kw, dtype, splits=splits, chunk=chunk)
    _check(args, kw, dtype, splits=splits, chunk=chunk, window=100)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,dh", [(1, 128), (2, 16), (3, 96), (3, 128),
                                  (2, 96), (1, 16), (4, 128), (7, 64),
                                  (8, 128)])
def test_split_decode_groups_and_head_widths(dtype, g, dh):
    rng = np.random.default_rng(g * 1000 + dh)
    lengths = [37, 250, 128, 5]
    for int8 in (False, True):
        args, kw = _case(rng, lengths, nb=16, g=g, dh=dh, dtype=dtype,
                         int8=int8)
        _check(args, kw, dtype, splits=5, chunk=4)
        _check(args, kw, dtype, splits=1, chunk=16, window=50)


def test_decode_splits_fills_the_card_from_host_numbers():
    # the serve shape: B = 8 slots, Kh = 8, a 64-column table bucket
    splits, chunk = decode_splits(8, 8, 64, SMS, group=3)
    assert 8 * 8 * splits >= 2 * SMS
    assert splits * chunk >= 64 > (splits - 1) * chunk
    # B x Kh already fills the card: one split over the whole table
    assert decode_splits(64, 8, 64, SMS, group=3) == (1, 64)
    assert decode_splits(128, 8, 256, SMS, group=3) == (1, 256)
    # a group wider than one block's heads counts its head chunks
    assert decode_splits(8, 8, 64, SMS, group=8)[0] < splits


@pytest.mark.parametrize("b,kh,g", [(1, 1, 1), (1, 8, 3), (8, 8, 3),
                                    (32, 8, 3), (3, 2, 2)])
def test_decode_splits_never_exceeds_the_columns(b, kh, g):
    for nb in list(range(0, 70)) + [128, 256, 1024]:
        splits, chunk = decode_splits(b, kh, nb, SMS, group=g)
        assert 1 <= splits <= max(1, min(nb, MAX_SPLITS)), (nb, splits)
        if nb:
            # every split owns at least one column; together all of them
            assert (splits - 1) * chunk < nb <= splits * chunk, (nb, splits,
                                                                 chunk)


@pytest.mark.parametrize("b,kh,g", [(8, 8, 3), (1, 8, 3), (3, 2, 2),
                                    (64, 8, 3)])
@pytest.mark.parametrize("width", [16, 17, 64, 256])
def test_decode_splits_chunk_follows_the_table_width(b, kh, g, width):
    """Passed ``nb`` columns of a ``width``-column table, a split owns the
    same ``chunk`` columns whatever ``nb`` is (the choice for the whole
    table), and the whole table keeps the plain choice."""
    plain = decode_splits(b, kh, width, SMS, group=g)
    assert decode_splits(b, kh, width, SMS, group=g, width=width) == plain
    for nb in range(1, width + 1):
        splits, chunk = decode_splits(b, kh, nb, SMS, group=g, width=width)
        assert chunk == plain[1], (nb, chunk)
        assert (splits - 1) * chunk < nb <= splits * chunk, (nb, splits)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
def test_split_decode_row_bits_do_not_depend_on_the_bucket(dtype, int8):
    """The serve shape's rows (8 slots of <= 16 blocks in a 64-column
    table) through 16, 32 and 64 of its columns: with the chunk of the
    whole table, the splits past a row's length add nothing, so the
    emulated outputs are equal bit for bit; the chunks ``decode_splits``
    gives each bucket alone (1, 2, 4 columns) partition the rows
    differently."""
    rng = np.random.default_rng(8)
    lengths = rng.integers(1, 16 * 16 + 1, size=8).tolist()
    args, kw = _case(rng, lengths, nb=64, kh=8, dtype=dtype, int8=int8)
    outs = []
    for nb in (16, 32, 64):
        cut = (*args[:3], args[3][:, :nb], args[4])
        splits, chunk = decode_splits(8, 8, nb, SMS, group=3, width=64)
        outs.append(_check(cut, kw, dtype, splits=splits, chunk=chunk))
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    assert {decode_splits(8, 8, nb, SMS, group=3)[1]
            for nb in (16, 32, 64)} == {1, 2, 4}
