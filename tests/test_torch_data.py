"""The port's data pipeline against ``repro``'s, on the CPU:

  * ``synthetic_oscar_text`` gives the reference's documents, word for
    word;
  * ``ByteFallbackTokenizer``: the same vocabulary and ids from the same
    documents (unknown words through the byte fallback included), the
    same decoded text, and a saved tokenizer loads in either package;
  * the indexed dataset: the ``.bin`` / ``.idx`` / ``.json`` files are
    byte-identical, and each package's reader reads the other's files
    (documents, packed samples, meta) equal;
  * ``ShardedLoader`` over ``lm_sample_fn``: batches equal to the
    reference's for rank/world 0/1, 1/2 and 3/4 and from a
    ``start_step``;
  * ``make_data_iter``: batches equal to the reference's (as numpy) and
    to the port's ``make_data_fn``, step for step, side inputs included.

Everything is exact (integers and strings); no tolerance.
"""
import filecmp

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data import indexed as ref_indexed
from repro.data import loader as ref_loader
from repro.data import synthetic as ref_synthetic
from repro.data import tokenizer as ref_tokenizer
from repro.launch import train as ref_train
from repro_torch.configs import get_config
from repro_torch.data import indexed, loader, synthetic, tokenizer
from repro_torch.launch import train

SEQ = 16
PKGS = {"ref": (ref_indexed, ref_loader, ref_tokenizer),
        "port": (indexed, loader, tokenizer)}


@pytest.fixture(scope="module")
def docs():
    return synthetic.synthetic_oscar_text(40, seed=3, words_per_doc=30)


@pytest.mark.parametrize("n,seed,words", [(40, 3, 30), (5, 0, 200)])
def test_synthetic_oscar_text_matches_reference(n, seed, words):
    assert synthetic._WORDS == ref_synthetic._WORDS
    assert synthetic.synthetic_oscar_text(n, seed, words) == \
        ref_synthetic.synthetic_oscar_text(n, seed, words)


@pytest.mark.parametrize("max_vocab", [280, 50257])
def test_tokenizer_vocabulary_and_ids_match_reference(docs, max_vocab):
    tok = tokenizer.ByteFallbackTokenizer.train(docs, max_vocab=max_vocab)
    ref = ref_tokenizer.ByteFallbackTokenizer.train(docs,
                                                    max_vocab=max_vocab)
    assert tok.word_to_id == ref.word_to_id
    assert (tok.vocab_size, tok.bos, tok.eos) == \
        (ref.vocab_size, ref.bos, ref.eos)
    texts = docs[:5] + ["benchmark ünïcode-word energy", "", "  spaced  "]
    for text in texts:
        for special in (True, False):
            ids = tok.encode(text, add_special=special)
            assert ids == ref.encode(text, add_special=special)
            assert tok.decode(ids) == ref.decode(ids)


def test_tokenizer_files_load_in_either_package(docs, tmp_path):
    for src, dst in (("port", "ref"), ("ref", "port")):
        tok = PKGS[src][2].ByteFallbackTokenizer.train(docs, max_vocab=300)
        path = tmp_path / f"{src}.json"
        tok.save(path)
        back = PKGS[dst][2].ByteFallbackTokenizer.load(path)
        assert back.word_to_id == tok.word_to_id
        assert back.max_vocab == tok.max_vocab
        assert back.encode(docs[0]) == tok.encode(docs[0])


def _write(pkg, prefix, docs, tok):
    w = PKGS[pkg][0].IndexedDatasetWriter(prefix)
    for d in docs:
        w.add_document(tok.encode(d))
    w.finalize(meta={"tokenizer": "byte-fallback", "docs": len(docs)})


@pytest.fixture(scope="module")
def datasets(docs, tmp_path_factory):
    """The same documents written by both packages."""
    tmp = tmp_path_factory.mktemp("indexed")
    tok = tokenizer.ByteFallbackTokenizer.train(docs, max_vocab=300)
    out = {}
    for pkg in PKGS:
        _write(pkg, tmp / pkg / "oscar", docs, tok)
        out[pkg] = tmp / pkg / "oscar"
    return out


def test_indexed_files_are_byte_identical(datasets):
    for suffix in (".bin", ".idx", ".json"):
        a = datasets["port"].with_suffix(suffix)
        b = datasets["ref"].with_suffix(suffix)
        assert filecmp.cmp(a, b, shallow=False), suffix
    assert datasets["port"].with_suffix(".idx").read_bytes()[:8] == \
        b"REPRIDX1"


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port"),
                                           ("port", "port")])
def test_readers_read_each_others_files(datasets, writer, reader):
    r = PKGS[reader][0].IndexedDatasetReader(datasets[writer])
    want = ref_indexed.IndexedDatasetReader(datasets["ref"])
    assert (r.n_documents, r.n_tokens, r.meta) == \
        (want.n_documents, want.n_tokens, want.meta)
    for i in range(r.n_documents):
        np.testing.assert_array_equal(r.document(i), want.document(i))
    for idx in (0, 1, 7, 10_000):
        np.testing.assert_array_equal(r.sample(idx, SEQ),
                                      want.sample(idx, SEQ))


@pytest.mark.parametrize("rank,world,start", [(0, 1, 0), (1, 2, 0),
                                              (3, 4, 0), (0, 1, 5),
                                              (1, 2, 3)])
def test_sharded_loader_batches_match_reference(datasets, rank, world,
                                                start):
    batches = {}
    for pkg, (idx_mod, load_mod, _) in PKGS.items():
        reader = idx_mod.IndexedDatasetReader(datasets[pkg])
        ld = load_mod.ShardedLoader(load_mod.lm_sample_fn(reader, SEQ), 8,
                                    rank=rank, world=world, start_step=start)
        try:
            batches[pkg] = [next(ld) for _ in range(4)]
        finally:
            ld.close()
        assert ld.step == start + 4
    for got, want in zip(batches["port"], batches["ref"]):
        assert got.keys() == want.keys() == {"tokens", "labels"}
        for k in got:
            assert isinstance(got[k], np.ndarray)
            assert got[k].shape == (8 // world, SEQ)
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ["gpt-117m", "whisper-small",
                                  "llava-next-34b"])
def test_make_data_iter_matches_reference_and_data_fn(arch):
    rc, c = ref_get_config(arch).reduced(), get_config(arch).reduced()
    want = ref_train.make_data_iter(rc, 4, SEQ, seed=2)
    got = train.make_data_iter(c, 4, SEQ, seed=2, device="cpu")
    data = train.make_data_fn(c, 4, SEQ, seed=2, device="cpu")
    try:
        for step in range(3):
            a, b, d = next(got), next(want), data(step)
            assert a.keys() == b.keys() == d.keys()
            for k in a:
                assert a[k].device.type == "cpu"
                assert a[k].dtype == d[k].dtype
                assert torch.equal(a[k], d[k]), (step, k)
                ref_np = np.asarray(b[k].astype(np.float32)
                                    if k in ("patch_embeds", "enc_frames")
                                    else b[k])
                np.testing.assert_array_equal(a[k].float().numpy()
                                              if a[k].is_floating_point()
                                              else a[k].numpy(), ref_np)
    finally:
        got.close()
