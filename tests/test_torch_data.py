"""The port's own data and text layers (``sse_tpu_torch.data``,
``sse_tpu_torch.text``) against the JAX package's (``sse_tpu.data``,
``sse_tpu.text``) on the same seeds: corpus rows, vocab subtokens and
ids, encoded arrays and batches are equal (exact comparisons: both are
pure Python and numpy), and a vocab file written by either package loads
in the other.
"""

import dataclasses

import numpy as np
import pytest

from sse_tpu.data import batching as jbatching
from sse_tpu.data import corpus as jcorpus
from sse_tpu.data import synthetic as jsynthetic
from sse_tpu.text import subword as jsubword
from sse_tpu_torch.data import batching as tbatching
from sse_tpu_torch.data import corpus as tcorpus
from sse_tpu_torch.data import synthetic as tsynthetic
from sse_tpu_torch.text import subword as tsubword

TASKS = ["classification", "ranking", "crosslingual", "qna"]


def _arrays_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        elif f.name != "labels_multi":
            assert list(x) == list(y), f.name


@pytest.mark.parametrize("task", TASKS)
def test_make_corpus_rows_match(task):
    for seed in (0, 5):
        assert tsynthetic.make_corpus(task=task, num_targets=12, seed=seed) == \
            jsynthetic.make_corpus(task=task, num_targets=12, seed=seed)


def test_other_synthetic_corpora_match():
    hard = dict(task="ranking", num_targets=64, seed=1)
    assert tsynthetic.make_hard_corpus(**hard) == jsynthetic.make_hard_corpus(**hard)
    comp = dict(task="qna", num_targets=64, train_per_target=4, seed=2)
    assert tsynthetic.make_compositional_corpus(**comp) == \
        jsynthetic.make_compositional_corpus(**comp)


@pytest.mark.parametrize("task,mode", [("ranking", "subword"), ("qna", "subword"),
                                       ("classification", "word")])
def test_vocab_and_encodings_match(task, mode):
    """build_vocab (subtokens and ids), encode_target_space, encode_pairs
    and batch_encode give the same vocab and arrays in both packages."""
    rows, evrows, targets = jsynthetic.make_corpus(task=task, num_targets=10, seed=4)
    jv = jcorpus.build_vocab(400, rows, targets, vocab_mode=mode)
    tv = tcorpus.build_vocab(400, rows, targets, vocab_mode=mode)
    assert tv.vocab_size == jv.vocab_size
    texts = [s for s, _ in rows[:20]] + [t for _, t in targets] + ["zzqx unseen words!"]
    assert [tv.encode(t) for t in texts] == [jv.encode(t) for t in texts]
    if mode == "subword":
        assert [tv.id_to_subtoken(i) for i in range(tv.vocab_size)] == \
            [jv.id_to_subtoken(i) for i in range(jv.vocab_size)]
    jt = jcorpus.encode_target_space(jv, targets, 16)
    tt = tcorpus.encode_target_space(tv, targets, 16)
    _arrays_equal(tt, jt)
    for split in (rows, evrows):
        _arrays_equal(tcorpus.encode_pairs(tv, split, tt, 16),
                      jcorpus.encode_pairs(jv, split, jt, 16))
    for a, b in zip(tcorpus.batch_encode(tv, texts, 16), jcorpus.batch_encode(jv, texts, 16)):
        np.testing.assert_array_equal(a, b)


def test_batch_iterator_matches():
    rows, _, targets = jsynthetic.make_corpus(task="ranking", num_targets=10, seed=6)
    vocab = jcorpus.build_vocab(300, rows, targets)
    tspace = jcorpus.encode_target_space(vocab, targets, 12)
    pairs = jcorpus.encode_pairs(vocab, rows, tspace, 12)
    for kw in ({}, {"shuffle_window": 16}, {"process_index": 1, "process_count": 2}):
        jit = jbatching.BatchIterator(pairs, 16, seed=3, **kw)
        tit = tbatching.BatchIterator(pairs, 16, seed=3, **kw)
        assert tit.steps_per_epoch == jit.steps_per_epoch
        for epoch in (0, 1):
            for tb, jb in zip(tit.epoch_batches(epoch), jit.epoch_batches(epoch), strict=True):
                for f in dataclasses.fields(jb):
                    x, y = getattr(tb, f.name), getattr(jb, f.name)
                    if x is None or y is None:
                        assert x is y, f.name
                    else:
                        np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_vocab_files_load_in_the_other_package(tmp_path, writer):
    rows, _, targets = jsynthetic.make_corpus(task="crosslingual", num_targets=8, seed=7)
    build = jcorpus.build_vocab if writer == "jax" else tcorpus.build_vocab
    vocab = build(300, rows, targets)
    path = str(tmp_path / "vocab.subwords")
    vocab.save(path)
    other = (tsubword if writer == "jax" else jsubword).SubwordVocab.load(path)
    assert other.vocab_size == vocab.vocab_size
    assert other.content_digest() == vocab.content_digest()
    texts = [s for s, _ in rows[:10]]
    assert [other.encode(t) for t in texts] == [vocab.encode(t) for t in texts]
    loaded = (tcorpus if writer == "jax" else jcorpus).load_vocab(path)
    assert [loaded.encode(t) for t in texts] == [vocab.encode(t) for t in texts]
