"""The port's C++ subword encoder (``sse_tpu_torch.native``) against the
port's pure-Python text layer, the JAX package's C++ encoder
(``sse_tpu.native``) and the JAX package's Python text layer, on the
inputs of tests/test_native.py: ids, padded batches, token counts and
vocab builds are equal (exact comparisons), the golden vocab and
encodings are reproduced, the library is built under
``build/sse_tpu_torch/``, and a failed build raises instead of falling
back to Python.
"""

import json
import os
import random
import shutil
import string
import sys
import threading

import numpy as np
import pytest

from sse_tpu.data import corpus as jcorpus
from sse_tpu.native import NativeSubwordEncoder as JaxEncoder
from sse_tpu.text import subword as jsubword
from sse_tpu_torch.data import corpus as tcorpus
from sse_tpu_torch.native import (
    NativeSubwordEncoder,
    binding,
    build_library,
    native_available,
    native_build_subtokens,
    native_token_counts,
)
from sse_tpu_torch.text import subword as tsubword
from tests.test_text import SAMPLES, _demo_lines

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")


def _random_strings(n=300, seed=0):
    rng = random.Random(seed)
    chars = string.printable + "éß北🙂_\\;caffènaïve"
    return ["".join(rng.choice(chars) for _ in range(rng.randrange(60))) for _ in range(n)]


# escaping emits up to 6 ids a byte on these (code points 100-127 outside
# the alphabet), which the encode's buffer must survive
BLOWUP = ["{" * 200, "~{}" * 100, "e{" * 150, "{"]
# lone surrogates (a JSON body may carry them) and NUL bytes: the JAX
# package's binding cannot encode the former, so they are held against
# the Python encoders only
PORT_ONLY = ["\ud800", "x \udfff y", "🙂 pair of halves", "a\x00b", "\x00", "nul\x00 \x00"]

INPUTS = {
    "samples": SAMPLES,
    "demo_lines": _demo_lines(),
    "random_unicode": _random_strings(),
    "escape_blowup": BLOWUP,
}


COUNTS = tsubword.token_counts_from_lines(
    _demo_lines() + SAMPLES + ["under_score te\\xt 北京 déjà-vu 42 foo_bar_baz"] * 3
)


def _vocab_pair(name):
    """The same vocab in both packages: built from the demo lines at 300
    (tests/test_native.py's), the golden vocab file, or built from
    COUNTS, whose alphabet holds the newline, the tab, "_" and the
    backslash (so escaping meets characters that are single subtokens)."""
    if name == "golden":
        path = os.path.join(GOLDEN, "demo_vocab.txt")
        return tsubword.SubwordVocab.load(path), jsubword.SubwordVocab.load(path)
    if name == "odd_alphabet":
        return (
            tsubword.SubwordVocab.build_from_token_counts(COUNTS, 2, use_native=False),
            jsubword.SubwordVocab.build_from_token_counts(COUNTS, 2, use_native=False),
        )
    counts = tsubword.token_counts_from_lines(_demo_lines())
    return (
        tsubword.SubwordVocab.build_to_target_size(300, counts),
        jsubword.SubwordVocab.build_to_target_size(300, counts),
    )


@pytest.fixture(scope="module", params=["built_300", "golden", "odd_alphabet"])
def vocabs(request):
    tv, jv = _vocab_pair(request.param)
    assert [tv.id_to_subtoken(i) for i in range(tv.vocab_size)] == \
        [jv.id_to_subtoken(i) for i in range(jv.vocab_size)]
    return tv, jv


def _subtokens(v):
    return [v.id_to_subtoken(i) for i in range(v.vocab_size)]


@pytest.mark.parametrize("inputs", sorted(INPUTS))
def test_encode_matches_both_packages(vocabs, inputs):
    tv, jv = vocabs
    native, jax_native = NativeSubwordEncoder(tv), JaxEncoder(jv)
    for text in INPUTS[inputs]:
        want = tv.encode(text)
        assert native.encode(text) == want, repr(text)
        assert jax_native.encode(text) == want, repr(text)
        assert jv.encode(text) == want, repr(text)


def test_encode_lone_surrogates_and_nul(vocabs):
    tv, jv = vocabs
    native = NativeSubwordEncoder(tv)
    for text in PORT_ONLY:
        assert native.encode(text) == tv.encode(text) == jv.encode(text), repr(text)
    tokens, lengths = tcorpus.batch_encode(tv, PORT_ONLY, 24)
    want = tcorpus.batch_encode_python(tv, PORT_ONLY, 24)
    np.testing.assert_array_equal(tokens, want[0])
    np.testing.assert_array_equal(lengths, want[1])


@pytest.mark.parametrize("max_len", [1, 2, 12, 50])
def test_batch_encode_matches_plain_and_jax(vocabs, max_len):
    """Rows cut to max_len - 1 ids, EOS, zeros; empty and over-long rows."""
    tv, jv = vocabs
    texts = _demo_lines()[:8] + ["", "x" * 100, " ", "a b"] + BLOWUP + _random_strings(40, 3)
    got = tcorpus.batch_encode(tv, texts, max_len)
    direct = NativeSubwordEncoder(tv).encode_batch(texts, max_len)
    plain = tcorpus.batch_encode_python(tv, texts, max_len)
    jax_native = jcorpus.batch_encode(jv, texts, max_len)
    for arrays in (direct, plain, jax_native):
        np.testing.assert_array_equal(got[0], arrays[0])
        np.testing.assert_array_equal(got[1], arrays[1])
    assert got[0].dtype == got[1].dtype == np.int32
    assert got[0].shape == (len(texts), max_len)
    for i, text in enumerate(texts):
        ids = tv.encode(text)[: max_len - 1] + [tsubword.EOS_ID]
        assert got[1][i] == len(ids)
        assert got[0][i, : len(ids)].tolist() == ids
        assert (got[0][i, len(ids):] == 0).all()


def test_batch_encode_empty_and_bad_width(vocabs):
    tv, _ = vocabs
    tokens, lengths = tcorpus.batch_encode(tv, [], 8)
    assert tokens.shape == (0, 8) and lengths.shape == (0,)
    with pytest.raises(ValueError, match="max_len"):
        NativeSubwordEncoder(tv).encode_batch(["a"], 0)


def test_token_vocab_keeps_the_python_loop(monkeypatch):
    """A TokenVocab never reaches the C++ encoder (as in the JAX package)."""
    counts = tsubword.token_counts_from_lines(_demo_lines())
    tv = tsubword.TokenVocab.build(counts, 20)
    jv = jsubword.TokenVocab.build(counts, 20)

    def refuse(*a, **k):
        raise AssertionError("a TokenVocab reached the C++ encoder")

    monkeypatch.setattr(NativeSubwordEncoder, "encode_batch", refuse)
    texts = _demo_lines() + ["unseen words here"]
    for a, b in zip(tcorpus.batch_encode(tv, texts, 10), jcorpus.batch_encode(jv, texts, 10)):
        np.testing.assert_array_equal(a, b)


def _many_lines():
    """70,000 lines: more than one of the counter's 65,536-line chunks."""
    rng = random.Random(7)
    words = sorted({w for line in _demo_lines() for w in line.split()}) + ["北京", "café"]
    return [" ".join(rng.choices(words, k=rng.randint(1, 6))) + rng.choice(["", "!", " _x"])
            for _ in range(70_000)]


@pytest.mark.parametrize("lines", ["demo_and_samples", "random_unicode", "port_only", "chunks"])
def test_token_counts_match(lines):
    data = {
        "demo_and_samples": _demo_lines() + [s for s in SAMPLES if s],
        "random_unicode": _random_strings(300, 1),
        "port_only": PORT_ONLY,
        "chunks": _many_lines(),
    }[lines]
    want = tsubword.token_counts_from_lines(data)
    assert native_token_counts(data) == want
    assert native_token_counts(iter(data)) == want  # a generator streams
    if lines != "port_only":
        assert jsubword.token_counts_from_lines(data) == want


@pytest.mark.parametrize("max_subtoken_length", [None, 0, 4])
@pytest.mark.parametrize("min_count", [1, 2, 5, 20])
def test_vocab_build_matches_python_and_jax(min_count, max_subtoken_length):
    """The native build (the default) equals the plain Python build and the
    JAX package's native build, subtokens and order."""
    kw = dict(min_count=min_count, max_subtoken_length=max_subtoken_length)
    native = tsubword.SubwordVocab.build_from_token_counts(COUNTS, **kw)
    plain = tsubword.SubwordVocab.build_from_token_counts(COUNTS, use_native=False, **kw)
    jax_native = jsubword.SubwordVocab.build_from_token_counts(COUNTS, use_native=True, **kw)
    assert _subtokens(native) == _subtokens(plain) == _subtokens(jax_native)
    assert native_build_subtokens(COUNTS, min_count, 4, max_subtoken_length) == \
        _subtokens(plain)[len(tsubword.RESERVED_TOKENS):]


def test_vocab_build_edge_inputs():
    """No tokens, and tokens holding lone surrogates, NUL and escapes."""
    odd = tsubword.token_counts_from_lines(PORT_ONLY + ["\\123; _u_ \\"] * 2)
    for counts in ({}, odd):
        for mc in (1, 2):
            assert _subtokens(tsubword.SubwordVocab.build_from_token_counts(counts, mc)) == \
                _subtokens(tsubword.SubwordVocab.build_from_token_counts(
                    counts, mc, use_native=False))


def test_build_to_target_size_matches_golden():
    golden = tsubword.SubwordVocab.load(os.path.join(GOLDEN, "demo_vocab.txt"))
    rebuilt = tsubword.SubwordVocab.build_to_target_size(
        200, native_token_counts(_demo_lines())
    )
    assert _subtokens(rebuilt) == _subtokens(golden)


def test_encodings_match_golden():
    vocab = tsubword.SubwordVocab.load(os.path.join(GOLDEN, "demo_vocab.txt"))
    with open(os.path.join(GOLDEN, "demo_encodings.json")) as f:
        samples = json.load(f)
    native = NativeSubwordEncoder(vocab)
    texts = list(samples)
    tokens, lengths = tcorpus.batch_encode(vocab, texts, 64)
    for i, text in enumerate(texts):
        assert native.encode(text) == samples[text], text
        assert tokens[i, : lengths[i] - 1].tolist() == samples[text][:63], text


@pytest.mark.parametrize("mode", ["subword", "word"])
def test_build_vocab_paths_match_jax(tmp_path, mode):
    """corpus.build_vocab and build_vocab_streaming (a TrainPairs file read
    line by line) give the JAX package's vocab."""
    from sse_tpu_torch.data import synthetic

    rows, _, targets = synthetic.make_corpus(task="ranking", num_targets=16, seed=2)
    tsv = tmp_path / "TrainPairs"
    tsv.write_text("".join(f"{s}\t{','.join(t)}\n" for s, t in rows), encoding="utf-8")
    tv = tcorpus.build_vocab(400, rows, targets, vocab_mode=mode)
    jv = jcorpus.build_vocab(400, rows, targets, vocab_mode=mode)
    ts = tcorpus.build_vocab_streaming(400, str(tsv), targets, vocab_mode=mode)
    js = jcorpus.build_vocab_streaming(400, str(tsv), targets, vocab_mode=mode)
    assert tv.vocab_size == jv.vocab_size == ts.vocab_size == js.vocab_size
    texts = [s for s, _ in rows] + [t for _, t in targets] + ["zzqx unseen!"]
    want = [jv.encode(t) for t in texts]
    assert [tv.encode(t) for t in texts] == want == [ts.encode(t) for t in texts]
    if mode == "subword":
        assert _subtokens(tv) == _subtokens(jv) == _subtokens(ts) == _subtokens(js)


def test_corpus_encodes_go_through_native(monkeypatch):
    """encode_target_space and encode_pairs reach the C++ encoder and give
    the JAX package's arrays."""
    from sse_tpu_torch.data import synthetic

    calls = []
    real = NativeSubwordEncoder.encode_batch

    def counted(self, texts, max_len, eos_id=tsubword.EOS_ID):
        calls.append(len(texts))
        return real(self, texts, max_len, eos_id)

    monkeypatch.setattr(NativeSubwordEncoder, "encode_batch", counted)
    rows, _, targets = synthetic.make_corpus(task="qna", num_targets=12, seed=5)
    tv = tcorpus.build_vocab(300, rows, targets)
    jv = jcorpus.build_vocab(300, rows, targets)
    tt = tcorpus.encode_target_space(tv, targets, 16)
    jt = jcorpus.encode_target_space(jv, targets, 16)
    tp = tcorpus.encode_pairs(tv, rows, tt, 16)
    jp = jcorpus.encode_pairs(jv, rows, jt, 16)
    assert calls == [len(targets), len(rows)]
    np.testing.assert_array_equal(tt.tokens, jt.tokens)
    np.testing.assert_array_equal(tt.lengths, jt.lengths)
    np.testing.assert_array_equal(tp.src, jp.src)
    np.testing.assert_array_equal(tp.src_len, jp.src_len)


def test_threads_share_one_encoder(vocabs, monkeypatch):
    """Sixteen threads (more than this machine's cores) race on a fresh
    copy of the vocab: the cache builds one encoder, which every thread
    shares, and each call gets the plain version's arrays."""
    tv = tsubword.SubwordVocab(_subtokens(vocabs[0])[len(tsubword.RESERVED_TOKENS):])
    texts = _random_strings(200, 11) + _demo_lines()
    want = tcorpus.batch_encode_python(tv, texts, 20)
    built = []

    class Counted(NativeSubwordEncoder):
        def __init__(self, vocab):
            built.append(vocab)
            super().__init__(vocab)

    monkeypatch.setattr(tcorpus, "NativeSubwordEncoder", Counted)
    n = 16
    out, errors, start = [None] * n, [], threading.Barrier(n)

    def run(i):
        try:
            start.wait(timeout=60)
            for _ in range(10):
                out[i] = tcorpus.batch_encode(tv, texts, 20)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert built == [tv]
    for got in out:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_library_lands_under_build():
    path = build_library()
    assert os.path.dirname(path) == os.path.join(ROOT, "build", "sse_tpu_torch")
    assert os.path.basename(path).startswith("libsse_encoder_") and path.endswith(".so")
    assert native_available()
    here = os.path.join(ROOT, "sse_tpu_torch", "native")
    assert sorted(f for f in os.listdir(here) if f != "__pycache__") == \
        ["__init__.py", "binding.py", "encoder.cpp"]


@pytest.mark.parametrize("fault", ["compiler_false", "bad_flag", "bad_source"])
def test_failed_build_raises(tmp_path, monkeypatch, capfd, fault):
    """A build that fails raises with the compiler's stderr, in every
    caller, and nothing falls back to the Python encoder."""
    monkeypatch.setattr(binding, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(binding, "_lib", None)
    want = "build failed"
    if fault == "compiler_false":
        monkeypatch.setattr(binding, "_compiler", lambda: shutil.which("false"))
    elif fault == "bad_flag":
        monkeypatch.setattr(binding, "CXX_FLAGS", [*binding.CXX_FLAGS, "-fno-such-option-xyz"])
        want = "fno-such-option-xyz"
    else:
        src = tmp_path / "encoder.cpp"
        src.write_text("int broken( {\n")
        monkeypatch.setattr(binding, "SRC", str(src))
        want = "error"
    with pytest.raises(RuntimeError, match=want):
        build_library(quiet=False)
    assert binding.SRC in capfd.readouterr().err  # quiet=False printed the command
    assert not native_available()
    counts = tsubword.token_counts_from_lines(_demo_lines())
    vocab = tsubword.SubwordVocab.build_from_token_counts(counts, 2, use_native=False)
    for call in (
        lambda: tcorpus.batch_encode(vocab, ["iphone case"], 8),
        lambda: tsubword.SubwordVocab.build_from_token_counts(counts, 2),
        lambda: native_token_counts(_demo_lines()),
        lambda: tcorpus.build_vocab(100, [("a b", ["t"])], [("t", "c d")]),
    ):
        with pytest.raises(RuntimeError, match=want):
            call()
    assert [p.name for p in (tmp_path / "build").iterdir()] == ["libsse_encoder.lock"]
