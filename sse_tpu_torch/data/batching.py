"""Batch generation: static shapes, shuffled epochs, per-host sharding (a
copy of ``sse_tpu/data/batching.py`` for the PyTorch port: same batches
for the same seed).

Replaces the reference's feed_dict batch generator (SURVEY.md §2.1 data
pipeline row) with a TPU-shaped iterator:

  * every batch has the SAME static shape (last partial batch is padded and
    masked via a per-example weight) → exactly one XLA compilation;
  * optional per-host slicing for multi-host SPMD (each host feeds its own
    shard of the global batch; SURVEY.md §2.2 DP row);
  * deterministic shuffling from an integer seed, resumable via epoch index.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from sse_tpu_torch.data.corpus import EncodedPairs


@dataclasses.dataclass
class Batch:
    """One training/eval step's host-side input (numpy; device put happens
    in the train loop with the mesh's input sharding)."""

    src: np.ndarray  # [B, L] int32
    src_len: np.ndarray  # [B] int32
    labels: np.ndarray  # [B] int32
    weight: np.ndarray  # [B] float32, 0.0 for padding examples
    # [B, M] int32 -1-padded full label sets (col 0 == labels); None for
    # single-label corpora — see EncodedPairs.labels_multi
    labels_multi: Optional[np.ndarray] = None


def pad_batch(
    src: np.ndarray,
    src_len: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    labels_multi: Optional[np.ndarray] = None,
) -> Batch:
    """Pad a possibly-short batch up to `batch_size` with weight-0 rows."""
    n = src.shape[0]
    weight = np.ones((batch_size,), dtype=np.float32)
    if n < batch_size:
        pad = batch_size - n
        src = np.concatenate(
            [src, np.zeros((pad, src.shape[1]), dtype=src.dtype)]
        )
        # Padding rows get length 1 (the EOS slot) to keep scans well-formed.
        src_len = np.concatenate([src_len, np.ones((pad,), dtype=src_len.dtype)])
        labels = np.concatenate([labels, np.zeros((pad,), dtype=labels.dtype)])
        weight[n:] = 0.0
        if labels_multi is not None:
            lm_pad = np.full((pad, labels_multi.shape[1]), -1, np.int32)
            lm_pad[:, 0] = 0  # mirror the padded `labels` rows
            labels_multi = np.concatenate([labels_multi, lm_pad])
    return Batch(
        src=src, src_len=src_len, labels=labels, weight=weight,
        labels_multi=labels_multi,
    )


class BatchIterator:
    """Shuffled, epoch-based, statically-shaped batch stream.

    `process_index` / `process_count` slice the *global* batch for this
    host (identity on single-host). `global_batch_size` must divide by
    `process_count`.
    """

    def __init__(
        self,
        pairs: EncodedPairs,
        global_batch_size: int,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        drop_remainder: bool = False,
        shuffle_window: Optional[int] = None,
    ):
        if global_batch_size % process_count:
            raise ValueError("global_batch_size must divide process_count")
        self._pairs = pairs
        self._global_bs = global_batch_size
        self._local_bs = global_batch_size // process_count
        self._seed = seed
        self._pidx = process_index
        self._pcount = process_count
        self._drop_remainder = drop_remainder
        # Windowed shuffle for memmapped (streaming) corpora: permute
        # window ORDER and rows WITHIN each window instead of the whole
        # corpus, so a batch's gathers stay within one window's pages
        # (full-corpus random access would fault across the entire file).
        # Every example still appears exactly once per epoch.
        self._shuffle_window = shuffle_window
        self.epoch = 0  # checkpointable (SURVEY.md §5 checkpoint row)

    @property
    def local_batch_size(self) -> int:
        return self._local_bs

    @property
    def steps_per_epoch(self) -> int:
        n = self._pairs.num_examples
        if self._drop_remainder:
            return n // self._global_bs
        return -(-n // self._global_bs)

    def epoch_batches(
        self, epoch: Optional[int] = None, start: int = 0
    ) -> Iterator[Batch]:
        """Yield this host's batches for one epoch (deterministic in
        (seed, epoch) so every host agrees on the permutation).

        `start` begins at that batch index within the epoch's fixed
        permutation — mid-epoch resume uses it to skip already-consumed
        batches with index arithmetic only, rather than materializing
        (gathering + padding) tens of thousands of skipped batches from
        the memmapped corpus."""
        if epoch is None:
            epoch = self.epoch
        rng = np.random.default_rng(np.uint64(self._seed * 1_000_003 + epoch))
        n = self._pairs.num_examples
        w = self._shuffle_window
        if w and n > w:
            n_windows = -(-n // w)
            parts = []
            for wi in rng.permutation(n_windows):
                lo = int(wi) * w
                hi = min(n, lo + w)
                parts.append(lo + rng.permutation(hi - lo))
            perm = np.concatenate(parts)
        else:
            perm = rng.permutation(n)
        n = len(perm)
        steps = self.steps_per_epoch
        for s in range(start, steps):
            lo = s * self._global_bs
            idx = perm[lo : lo + self._global_bs]
            # This host's slice of the global batch.
            local = idx[self._pidx :: self._pcount][: self._local_bs]
            lm = getattr(self._pairs, "labels_multi", None)
            yield pad_batch(
                self._pairs.src[local],
                self._pairs.src_len[local],
                self._pairs.labels[local],
                self._local_bs,
                labels_multi=None if lm is None else lm[local],
            )
        self.epoch = epoch + 1
