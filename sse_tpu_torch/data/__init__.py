"""Data layer of the port: corpus schema, encoding, batching and the
synthetic demo corpora (a copy of ``sse_tpu.data``; Python and numpy,
with a ``SubwordVocab``'s encodes in the C++ encoder of
``sse_tpu_torch.native``; no JAX)."""

from sse_tpu_torch.data import synthetic
from sse_tpu_torch.data.batching import BatchIterator, pad_batch
from sse_tpu_torch.data.corpus import (
    EncodedPairs,
    TargetSpace,
    build_vocab,
    encode_pairs,
    encode_target_space,
    read_pairs_tsv,
    read_targets_tsv,
)

__all__ = [
    "EncodedPairs",
    "TargetSpace",
    "read_pairs_tsv",
    "read_targets_tsv",
    "build_vocab",
    "encode_pairs",
    "encode_target_space",
    "BatchIterator",
    "pad_batch",
    "synthetic",
]
