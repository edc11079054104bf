"""Corpus schema + encoding (a copy of ``sse_tpu/data/corpus.py`` for the
PyTorch port; same ids, same files). A ``SubwordVocab``'s token counts,
vocab build and encodes run in the port's C++ encoder
(``sse_tpu_torch.native``), as the JAX package's do in its own.

Reference file-format parity (SURVEY.md §2.1 "Demo datasets" row):
  * ``TrainPairs`` / ``EvalPairs``: TSV, ``source_text \\t target_id`` where
    target_id may be a ``,``/``|``-separated list (first entry is the
    training label; the full set counts for recall@k).
  * ``targetIDs``: TSV, ``target_id \\t target_text``.

Encoding turns text into fixed-shape int32 token matrices
(EOS-terminated, zero-padded to ``max_seq_length``) — static shapes are a
TPU/XLA requirement (one compilation, MXU-friendly tiles), unlike the
reference's feed_dict-shaped batches.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sse_tpu_torch.native import NativeSubwordEncoder, native_token_counts
from sse_tpu_torch.text.subword import (
    EOS_ID,
    SubwordVocab,
    TokenVocab,
    load_vocab,
)


@dataclasses.dataclass
class TargetSpace:
    """The full encoded target corpus (the retrieval index's text side)."""

    ids: List[str]  # external target ids, row order = label index
    texts: List[str]
    tokens: np.ndarray  # [T, L] int32, EOS-terminated, 0-padded
    lengths: np.ndarray  # [T] int32 (including EOS)
    id_to_row: Dict[str, int]

    @property
    def num_targets(self) -> int:
        return len(self.ids)


@dataclasses.dataclass
class EncodedPairs:
    """Encoded (source, label) pairs for training or evaluation."""

    src: np.ndarray  # [N, L] int32
    src_len: np.ndarray  # [N] int32
    labels: np.ndarray  # [N] int32 target-space row index (first label)
    label_sets: List[Tuple[int, ...]]  # all correct rows per example
    # [N, M] int32, -1-padded, column 0 == labels — present only when some
    # row is MULTI-label (the reference's "t1,t2" TSV convention). The
    # train step uses it for label-set-aware false-negative masking: a
    # candidate that is ANY of example i's labels must not be pushed away
    # as a negative (training on rows[0] alone treats the sibling label
    # as a negative — r2 verdict quality item).
    labels_multi: Optional[np.ndarray] = None

    @property
    def num_examples(self) -> int:
        return self.src.shape[0]


# ---------------------------------------------------------------- raw TSVs
def read_pairs_tsv(path: str) -> List[Tuple[str, List[str]]]:
    """Read TrainPairs/EvalPairs: (source_text, [target_id, ...]) rows."""
    rows: List[Tuple[str, List[str]]] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\r\n")
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) < 2:
                continue
            src, tgt = parts[0], parts[1]
            tgt_ids = [t for t in tgt.replace("|", ",").split(",") if t]
            if tgt_ids:
                rows.append((src, tgt_ids))
    return rows


def read_targets_tsv(path: str) -> List[Tuple[str, str]]:
    """Read targetIDs: (target_id, target_text) rows."""
    rows: List[Tuple[str, str]] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\r\n")
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) >= 2:
                rows.append((parts[0], parts[1]))
    return rows


# ----------------------------------------------------------------- encoding
def build_vocab(
    vocab_size: int,
    pair_rows: Sequence[Tuple[str, List[str]]],
    target_rows: Sequence[Tuple[str, str]],
    cache_path: Optional[str] = None,
    max_subtoken_length: Optional[int] = 20,
    vocab_mode: str = "subword",
):
    """Build (or load cached) vocab over sources + target texts.

    Mirrors the reference's one-time vocab prep (SURVEY.md §3.5) including
    the load-if-cached behavior keyed on the vocab file's existence.
    ``vocab_mode``: "subword" (SubwordTextEncoder analog, default) or
    "word" (TokenTextEncoder analog: top-N whole tokens + OOV).
    """
    if cache_path and os.path.exists(cache_path):
        return load_vocab(cache_path)
    lines = [src for src, _ in pair_rows] + [txt for _, txt in target_rows]
    counts = native_token_counts(lines)
    if vocab_mode == "word":
        vocab = TokenVocab.build(counts, vocab_size)
    else:
        # max_subtoken_length bounds the build's O(len²) candidate loop —
        # essential for web-scale corpora; 20 chars covers natural subwords.
        vocab = SubwordVocab.build_to_target_size(
            vocab_size,
            counts,
            max_subtoken_length=max_subtoken_length,
        )
    if cache_path:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        vocab.save(cache_path)
    return vocab


def build_vocab_streaming(
    vocab_size: int,
    train_tsv_path: Optional[str],
    target_rows: Sequence[Tuple[str, str]],
    cache_path: Optional[str] = None,
    max_subtoken_length: Optional[int] = 20,
    vocab_mode: str = "subword",
):
    """build_vocab for corpora >> RAM: token counting streams the
    TrainPairs file line-by-line (never materializing the rows) through
    the C++ counter, then the build runs on the count dict — whose size is bounded by the
    UNIQUE token count, not the corpus size."""
    if cache_path and os.path.exists(cache_path):
        return load_vocab(cache_path)

    def lines():
        if train_tsv_path and os.path.exists(train_tsv_path):
            with open(train_tsv_path, "r", encoding="utf-8") as f:
                for line in f:
                    tab = line.find("\t")
                    if tab > 0:
                        yield line[:tab]
        for _, txt in target_rows:
            yield txt

    counts = native_token_counts(lines())
    if vocab_mode == "word":
        vocab = TokenVocab.build(counts, vocab_size)
    else:
        vocab = SubwordVocab.build_to_target_size(
            vocab_size, counts, max_subtoken_length=max_subtoken_length
        )
    if cache_path:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        vocab.save(cache_path)
    return vocab


def _encode_line(vocab: SubwordVocab, text: str, max_len: int) -> Tuple[np.ndarray, int]:
    ids = vocab.encode(text)[: max_len - 1] + [EOS_ID]
    arr = np.zeros((max_len,), dtype=np.int32)
    arr[: len(ids)] = ids
    return arr, len(ids)


def batch_encode(
    vocab: SubwordVocab, texts: Sequence[str], max_len: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Encode many lines → ([N, max_len] tokens, [N] lengths), EOS-padded.

    A ``SubwordVocab`` encodes in C++ (``NativeSubwordEncoder``, one per
    vocab, shared by every thread; a failed library build raises). Any
    other vocab (``TokenVocab``: a dict lookup a token) takes
    :func:`batch_encode_python`, the plain version, which gives the same
    arrays."""
    if not isinstance(vocab, SubwordVocab):
        return batch_encode_python(vocab, texts, max_len)
    with _native_lock:
        enc = _native_cache.get(vocab)
        if enc is None:
            enc = _native_cache[vocab] = NativeSubwordEncoder(vocab)
    return enc.encode_batch(texts, max_len, EOS_ID)


_native_lock = threading.Lock()
_native_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def batch_encode_python(
    vocab, texts: Sequence[str], max_len: int
) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`batch_encode` in pure Python, one line at a time."""
    tokens = np.zeros((len(texts), max_len), dtype=np.int32)
    lengths = np.zeros((len(texts),), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens[i], lengths[i] = _encode_line(vocab, text, max_len)
    return tokens, lengths



def trimmed_width(
    lengths: np.ndarray, full_width: int, multiple: int = 8
) -> int:
    """Smallest multiple-of-``multiple`` column count covering every
    sequence, capped at ``full_width``.

    Every tower masks past each row's length (masked scan / masked mean /
    masked attention — models/towers.py), so columns beyond the corpus
    max are pure padding for EVERY row and slicing them off is
    numerics-neutral. It is NOT free compute: the RNN scan is a
    sequential chain over L, and real corpora sit far below
    ``max_seq_length`` (hard benchmark: max 16 tokens on width-50
    arrays), so trimming cuts the latency-bound recurrence ~3× — the
    binding resource of the train step (BASELINE.md roofline). Rounding
    to a multiple keeps the set of distinct compiled widths small across
    corpus regenerations."""
    if len(lengths) == 0:
        return full_width
    m = int(np.max(lengths))
    w = -(-m // multiple) * multiple
    return min(full_width, max(multiple, w))


def encode_target_space(
    vocab: SubwordVocab,
    target_rows: Sequence[Tuple[str, str]],
    max_seq_length: int,
    cache_path: Optional[str] = None,
) -> TargetSpace:
    """Encode every target once (reference's encodeFullTargetSpace analog,
    SURVEY.md §2.1), with an .npz disk cache keyed on content."""
    ids = [tid for tid, _ in target_rows]
    texts = [txt for _, txt in target_rows]
    key = None
    if cache_path:
        h = hashlib.sha256()
        # vocab CONTENT, not just size: a regenerated vocab.txt of the same
        # size but different subtokens must invalidate the token cache
        h.update(repr((max_seq_length, vocab.content_digest())).encode())
        for tid, txt in target_rows:
            h.update(tid.encode())
            h.update(txt.encode())
        key = h.hexdigest()[:16]
        if os.path.exists(cache_path):
            with np.load(cache_path, allow_pickle=False) as z:
                if str(z["key"]) == key:
                    toks, lens = z["tokens"], z["lengths"]
                    return TargetSpace(
                        ids=ids,
                        texts=texts,
                        tokens=toks[:, : trimmed_width(lens, toks.shape[1])],
                        lengths=lens,
                        id_to_row={t: i for i, t in enumerate(ids)},
                    )
    tokens, lengths = batch_encode(vocab, texts, max_seq_length)
    if cache_path and key is not None:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        # cache at FULL width (key stays a pure function of the inputs);
        # the pad trim is applied on the way out of both paths
        np.savez(cache_path, key=key, tokens=tokens, lengths=lengths)
    tokens = tokens[:, : trimmed_width(lengths, tokens.shape[1])]
    return TargetSpace(
        ids=ids,
        texts=texts,
        tokens=tokens,
        lengths=lengths,
        id_to_row={t: i for i, t in enumerate(ids)},
    )


def encode_pairs_streaming(
    vocab: SubwordVocab,
    tsv_path: str,
    target_space: TargetSpace,
    max_seq_length: int,
    cache_dir: str,
    chunk_rows: int = 65536,
) -> EncodedPairs:
    """Corpus-scale TrainPairs encoding: stream the TSV in chunks through
    the encoder into MEMMAPPED token/label files, so training
    sets far larger than RAM work under a fixed memory cap — the r1
    pipeline held everything in Python lists/ndarrays (VERDICT r1 item 6;
    SURVEY.md §2.1 data-pipeline row at the north star's scale).

    Returns an EncodedPairs whose arrays are read-only ``np.memmap`` views
    (shape-compatible everywhere an in-memory EncodedPairs is accepted;
    ``label_sets`` holds first-label singletons and ``labels_multi`` stays
    None — the streaming path trains on the FIRST label of each row;
    label-set-aware masking of multi-label train rows requires the
    in-memory path. Multi-label sets always count for EVAL pairs, which
    stay in-memory). The cache is keyed on
    (vocab content, max_seq_length, TSV size+mtime, target-id order), so
    re-runs reopen the memmaps instantly.
    """
    os.makedirs(cache_dir, exist_ok=True)
    st = os.stat(tsv_path)
    key = hashlib.sha256(
        repr(
            (
                vocab.content_digest(),
                max_seq_length,
                st.st_size,
                int(st.st_mtime_ns),
                # labels are ROW INDICES into the target space, so the
                # cache must key on the target id ORDER, not just the
                # count — a reordered/edited targetIDs file with the same
                # row count would silently remap every cached label
                hashlib.sha256(
                    "\x00".join(target_space.ids).encode()
                ).hexdigest(),
            )
        ).encode()
    ).hexdigest()[:16]
    meta_path = os.path.join(cache_dir, "pairs_meta.json")
    src_path = os.path.join(cache_dir, "pairs_src.npy")
    len_path = os.path.join(cache_dir, "pairs_len.npy")
    lab_path = os.path.join(cache_dir, "pairs_lab.npy")

    import json as _json

    if os.path.exists(meta_path):
        with open(meta_path, "r", encoding="utf-8") as f:
            meta = _json.load(f)
        if meta.get("key") == key:
            n = meta["n"]
            src = np.load(src_path, mmap_mode="r")[:n]
            src_len = np.load(len_path, mmap_mode="r")[:n]
            labels = np.load(lab_path, mmap_mode="r")[:n]
            return EncodedPairs(
                src=src[:, : trimmed_width(src_len, src.shape[1])],
                src_len=src_len, labels=labels,
                label_sets=_LazySingletonSets(labels),
            )

    # pass 1: count lines (cheap, no parsing) to size the memmaps
    total = 0
    with open(tsv_path, "rb") as f:
        for _ in f:
            total += 1
    from numpy.lib.format import open_memmap

    src_mm = open_memmap(
        src_path, mode="w+", dtype=np.int32,
        shape=(max(total, 1), max_seq_length),
    )
    len_mm = open_memmap(
        len_path, mode="w+", dtype=np.int32, shape=(max(total, 1),)
    )
    lab_mm = open_memmap(
        lab_path, mode="w+", dtype=np.int32, shape=(max(total, 1),)
    )

    n = 0
    texts: List[str] = []
    labels: List[int] = []

    def flush():
        nonlocal n
        if not texts:
            return
        toks, lens = batch_encode(vocab, texts, max_seq_length)
        src_mm[n : n + len(texts)] = toks
        len_mm[n : n + len(texts)] = lens
        lab_mm[n : n + len(texts)] = np.asarray(labels, np.int32)
        n += len(texts)
        texts.clear()
        labels.clear()

    with open(tsv_path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\r\n")
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) < 2:
                continue
            tgt_ids = [
                t for t in parts[1].replace("|", ",").split(",") if t
            ]
            row = next(
                (
                    target_space.id_to_row[t]
                    for t in tgt_ids
                    if t in target_space.id_to_row
                ),
                None,
            )
            if row is None:
                continue  # reference's forgiving unknown-target behavior
            texts.append(parts[0])
            labels.append(row)
            if len(texts) >= chunk_rows:
                flush()
    flush()
    if n == 0:
        raise ValueError(f"no usable pairs in {tsv_path}")
    src_mm.flush(); len_mm.flush(); lab_mm.flush()
    del src_mm, len_mm, lab_mm  # drop write mappings before reopening
    with open(meta_path, "w", encoding="utf-8") as f:
        _json.dump({"key": key, "n": n, "total_lines": total}, f)
    src = np.load(src_path, mmap_mode="r")[:n]
    src_len = np.load(len_path, mmap_mode="r")[:n]
    lab = np.load(lab_path, mmap_mode="r")[:n]
    return EncodedPairs(
        src=src[:, : trimmed_width(src_len, src.shape[1])],
        src_len=src_len, labels=lab,
        label_sets=_LazySingletonSets(lab),
    )


class _LazySingletonSets:
    """label_sets stand-in for streaming pairs: materializing 10M tuples
    would defeat the memory cap; training never touches label_sets and
    eval pairs stay in-memory, so index/len access is all that's needed."""

    def __init__(self, labels):
        self._labels = labels

    def __len__(self):
        return len(self._labels)

    def __getitem__(self, i):
        return (int(self._labels[i]),)

    def __iter__(self):
        for x in self._labels:
            yield (int(x),)


def encode_pairs(
    vocab: SubwordVocab,
    pair_rows: Sequence[Tuple[str, List[str]]],
    target_space: TargetSpace,
    max_seq_length: int,
    drop_unknown_targets: bool = True,
) -> EncodedPairs:
    """Encode pair rows against a target space; unknown target ids are
    dropped (with the reference's forgiving behavior) or raise."""
    texts: List[str] = []
    labels: List[int] = []
    label_sets: List[Tuple[int, ...]] = []
    for src_text, tgt_ids in pair_rows:
        rows = [
            target_space.id_to_row[t]
            for t in tgt_ids
            if t in target_space.id_to_row
        ]
        if not rows:
            if drop_unknown_targets:
                continue
            raise KeyError(f"no known target ids in {tgt_ids!r}")
        texts.append(src_text)
        labels.append(rows[0])
        label_sets.append(tuple(rows))
    if not texts:
        raise ValueError("no usable pairs after encoding")
    src, src_len = batch_encode(vocab, texts, max_seq_length)
    src = src[:, : trimmed_width(src_len, src.shape[1])]
    # multi-label rows → dense [N, M] -1-padded matrix (static shape for
    # the jitted step; M capped at 8 — beyond that the extra labels add
    # mask columns but no signal)
    max_labels = min(max(len(s) for s in label_sets), 8)
    labels_multi = None
    if max_labels > 1:
        labels_multi = np.full((len(label_sets), max_labels), -1, np.int32)
        for i, s in enumerate(label_sets):
            row = s[:max_labels]
            labels_multi[i, : len(row)] = row
    return EncodedPairs(
        src=src,
        src_len=src_len,
        labels=np.asarray(labels, dtype=np.int32),
        label_sets=label_sets,
        labels_multi=labels_multi,
    )
