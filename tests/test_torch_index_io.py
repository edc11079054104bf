"""Index persistence across the two packages: the npy-v1 layout
(``emb_r*.npy``, ``docs.tsv``, ``sidecar.json``) written by either
``ShardedIndex.save`` loads in the other bit for bit, ids and texts
included; ``export_tsv`` writes the same bytes; ``import_tsv`` round-
trips; a corrupt ``docs.tsv`` and the legacy Orbax layout raise."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sse_tpu.index import sharded_index as jindex
from sse_tpu_torch.index import sharded_index as tindex

_JD = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}
_TD = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}

IDS = ["a", "tab\tid", "b\\c", "d", "e"]
TEXTS = ["plain text", "line\nbreak", "carriage\rreturn", "tab\there \\t", ""]


def _rows(n=5, d=16, seed=0):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _bits(a):
    """Raw bits of a host array (bf16 as uint16) for bit-equality."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _tbits(t):
    t = t.cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_jax_save_loads_in_port(tmp_path, dtype):
    j = jindex.from_embeddings(_rows(), IDS, TEXTS, dtype=_JD[dtype], capacity=12)
    j.save(str(tmp_path))
    t = tindex.ShardedIndex.load(str(tmp_path), device="cpu")
    assert t.emb.dtype == _TD[dtype] and tuple(t.emb.shape) == tuple(j.emb.shape)
    np.testing.assert_array_equal(_tbits(t.emb), _bits(j.emb).view(_tbits(t.emb).dtype))
    assert t.num_real == 5 and t.ids == IDS and t.texts == TEXTS


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_port_save_loads_in_jax(tmp_path, dtype):
    t = tindex.from_embeddings(_rows(seed=1), IDS, TEXTS, dtype=_TD[dtype], capacity=12,
                               device="cpu")
    t.save(str(tmp_path))
    j = jindex.ShardedIndex.load(str(tmp_path))
    assert str(j.emb.dtype) == {"f32": "float32", "bf16": "bfloat16", "int8": "int8"}[dtype]
    np.testing.assert_array_equal(_bits(j.emb).view(_tbits(t.emb).dtype), _tbits(t.emb))
    assert j.num_real == 5 and j.ids == IDS and j.texts == TEXTS
    side = json.loads((tmp_path / "sidecar.json").read_text())
    assert side["format"] == "npy-v1" and side["shape"] == [16, 16]


def test_save_after_live_changes_and_stale_files(tmp_path):
    """A re-save after add/delete keeps the live rows only, and drops the
    files the new sidecar does not name (a legacy ``emb/`` and another
    layout's ``emb_*.npy``)."""
    t = tindex.from_embeddings(_rows(), IDS, TEXTS, capacity=12, device="cpu")
    (tmp_path / "emb").mkdir()
    np.save(tmp_path / "emb_r000000000008.npy", np.zeros((2, 2), np.float32))
    t.add(_rows(2, seed=5), ["new1", "new2"], ["fresh\tone", "two"])
    t.delete(["a"])
    t.save(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["docs.tsv", "emb_r000000000000.npy", "sidecar.json"]
    back = tindex.ShardedIndex.load(str(tmp_path), device="cpu")
    assert back.ids == t.ids and back.texts == t.texts and back.num_real == 6
    assert torch.equal(back.emb, t.emb)
    j = jindex.ShardedIndex.load(str(tmp_path))
    assert j.ids == t.ids and j.num_real == 6


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_export_tsv_byte_identical(tmp_path, dtype):
    ids, texts = ["x1", "x2", "x3"], ["one", "two words", "three"]
    emb = _rows(3, seed=2)
    jindex.from_embeddings(emb, ids, texts, dtype=_JD[dtype]).export_tsv(str(tmp_path / "j.tsv"))
    tindex.from_embeddings(emb, ids, texts, dtype=_TD[dtype], device="cpu").export_tsv(
        str(tmp_path / "t.tsv")
    )
    assert (tmp_path / "j.tsv").read_bytes() == (tmp_path / "t.tsv").read_bytes()
    back = tindex.ShardedIndex.import_tsv(str(tmp_path / "t.tsv"), device="cpu")
    jback = jindex.ShardedIndex.import_tsv(str(tmp_path / "j.tsv"))
    assert back.ids == ids and back.texts == texts and back.emb.dtype == torch.float32
    np.testing.assert_array_equal(back.emb.numpy(), np.asarray(jback.emb))
    back.export_tsv(str(tmp_path / "again.tsv"))
    assert (tmp_path / "again.tsv").read_bytes() == (tmp_path / "t.tsv").read_bytes()


def test_corrupt_docs_tsv_raises(tmp_path):
    tindex.from_embeddings(_rows(), IDS, TEXTS, device="cpu").save(str(tmp_path))
    with open(tmp_path / "docs.tsv", "a", encoding="utf-8") as f:
        f.write("extra\trow\n")
    with pytest.raises(ValueError, match="corrupt index"):
        tindex.ShardedIndex.load(str(tmp_path), device="cpu")


def test_legacy_orbax_layout_raises(tmp_path):
    (tmp_path / "emb").mkdir()
    (tmp_path / "sidecar.json").write_text(
        json.dumps({"num_real": 1, "ids": ["a"], "texts": ["t"], "shape": [8, 4],
                    "dtype": "float32"})
    )
    with pytest.raises(ValueError, match="legacy Orbax"):
        tindex.ShardedIndex.load(str(tmp_path), device="cpu")
