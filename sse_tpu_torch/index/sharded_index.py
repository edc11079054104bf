"""Device-resident target-embedding index on one GPU (port of
``sse_tpu/index/sharded_index.py``).

Same geometry and invariants as the JAX index: ``[T_pad, D]`` rows,
L2-normalized, stored as float32, bfloat16 or int8 (symmetric 127-scale);
rows in ``[num_real, T_pad)`` are ZERO vectors; scoring masks them by the
runtime ``num_real``. ``pub`` publishes ``(emb, num_real, ids, texts)`` as
one attribute so a concurrent query sees the fully-old or the fully-new
index. Not ported yet (ROADMAP.md §1): save/load and the TSV format,
sharding over several devices.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from sse_tpu.data.corpus import TargetSpace
from sse_tpu_torch.models import sse
from sse_tpu_torch.models.sse import NetworkMode, SSEConfig

INT8_SCALE = 127  # L2-normalized rows live in [-1, 1]; symmetric int8


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def quantize_rows(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """L2-normalized rows → the index storage type. int8: round half to
    even at scale 127 (``torch.round`` matches ``jnp.round``)."""
    if dtype == torch.int8:
        return torch.clamp(torch.round(x.float() * INT8_SCALE), -127, 127).to(torch.int8)
    return x.to(dtype)


def _normalized(rows: torch.Tensor) -> torch.Tensor:
    rows = rows.float()
    return rows / torch.clamp(torch.linalg.norm(rows, dim=1, keepdim=True), min=1e-6)


@dataclasses.dataclass
class ShardedIndex:
    emb: torch.Tensor  # [T_pad, D] on the serving device
    num_real: int  # first num_real rows are valid
    ids: List[str]
    texts: List[str]
    # atomically published (emb, num_real, ids, texts) for lock-free readers
    pub: tuple = dataclasses.field(init=False, repr=False, default=None)

    def __post_init__(self):
        self._publish()

    def _publish(self) -> None:
        self.pub = (self.emb, self.num_real, self.ids, self.texts)

    @property
    def padded_size(self) -> int:
        return int(self.emb.shape[0])

    @property
    def capacity(self) -> int:
        return self.padded_size

    def add(self, emb_rows, ids: Sequence[str], texts: Sequence[str]) -> None:
        """Append documents into padding capacity (rows are L2-normalized
        here). Writes in place: the rows written lie at or past every
        published num_real, so a query holding the old snapshot never
        selects them. Raises when capacity is exhausted."""
        rows = emb_rows if torch.is_tensor(emb_rows) else torch.from_numpy(np.asarray(emb_rows))
        n = rows.shape[0]
        if self.num_real + n > self.capacity:
            raise ValueError(f"index full: {self.num_real}+{n} > capacity {self.capacity}")
        update = quantize_rows(_normalized(rows.to(self.emb.device)), self.emb.dtype)
        self.emb[self.num_real : self.num_real + n] = update
        self.ids.extend(ids)
        self.texts.extend(texts)
        self.num_real += n
        self._publish()

    def delete(self, target_ids: Sequence[str]) -> int:
        """Swap-with-last removal: each deleted row is overwritten by the
        current last real row, num_real shrinks, and the vacated rows are
        zeroed. The first write copies the buffer, so readers of the old
        snapshot keep a valid one. Returns the new num_real; raises
        KeyError on an unknown id."""
        id_pos = {tid: r for r, tid in enumerate(self.ids[: self.num_real])}
        rows = []
        for tid in target_ids:
            if tid not in id_pos:
                raise KeyError(f"unknown target id: {tid}")
            rows.append(id_pos[tid])
        if len(set(rows)) != len(rows):
            raise ValueError("duplicate target ids in delete()")
        new_ids = list(self.ids)
        new_texts = list(self.texts)
        emb = self.emb.clone() if rows else self.emb
        # descending order keeps position end-1 a survivor at every swap
        end = self.num_real
        for r in sorted(rows, reverse=True):
            end -= 1
            if end > r:
                emb[r] = emb[end]
                new_ids[r] = new_ids[end]
                new_texts[r] = new_texts[end]
            del new_ids[end]
            del new_texts[end]
        emb[end : self.num_real] = 0
        self.emb = emb
        self.num_real = end
        self.ids = new_ids
        self.texts = new_texts
        self._publish()
        return self.num_real


def _padded_rows(t: int, capacity: Optional[int], shards: int = 1) -> int:
    """Row padding geometry, unchanged from the JAX index (shape =
    serving compatibility): 4096-aligned for large indexes, 8 otherwise."""
    t_eff = max(t, capacity or 0)
    align = 4096 if t_eff >= 65536 else 8
    return _round_up(max(t_eff, 1), shards * align)


def from_embeddings(
    emb,
    ids: Sequence[str],
    texts: Sequence[str],
    dtype: torch.dtype = torch.float32,
    capacity: Optional[int] = None,
    device: torch.device | str = "cpu",
) -> ShardedIndex:
    """Wrap embeddings [T, D] (numpy or tensor) into a padded index."""
    emb = torch.as_tensor(emb).float()
    t, d = emb.shape
    padded = torch.zeros((_padded_rows(t, capacity), d), dtype=torch.float32)
    padded[:t] = emb.cpu()
    return ShardedIndex(
        emb=quantize_rows(padded.to(device), dtype),
        num_real=t,
        ids=list(ids),
        texts=list(texts),
    )


def _params_device(params) -> torch.device:
    return params["src_tower"]["embed"].device


def build_index(
    params,
    model_cfg: SSEConfig,
    target_space: TargetSpace,
    batch_size: int = 256,
    dtype: torch.dtype = torch.float32,
    capacity: Optional[int] = None,
) -> ShardedIndex:
    """Encode the whole target space into an index on the params' device.

    SOURCE_ENCODER_ONLY: the learned table is the index. Tower modes:
    token batches of ``batch_size`` go through the target tower (the GRU
    kernel on a GPU) and land in the preallocated buffer; rows in
    ``[num_targets, T_pad)`` stay zero."""
    device = _params_device(params)
    if model_cfg.mode == NetworkMode.SOURCE_ENCODER_ONLY:
        with torch.no_grad():
            emb = sse.target_embeddings(params, model_cfg)
        return from_embeddings(
            emb[: target_space.num_targets], target_space.ids, target_space.texts,
            dtype=dtype, capacity=capacity, device=device,
        )
    toks, lens = target_space.tokens, target_space.lengths
    t = toks.shape[0]
    buf = torch.zeros(
        (_padded_rows(t, capacity), model_cfg.encoding_dim), dtype=dtype, device=device
    )
    with torch.no_grad():
        for lo in range(0, t, batch_size):
            hi = min(lo + batch_size, t)
            out = sse.target_embeddings(
                params, model_cfg,
                tokens=torch.from_numpy(np.ascontiguousarray(toks[lo:hi])).to(device),
                lengths=torch.from_numpy(np.ascontiguousarray(lens[lo:hi])).to(device),
            )
            buf[lo:hi] = quantize_rows(out, dtype)
    return ShardedIndex(
        emb=buf, num_real=t, ids=list(target_space.ids), texts=list(target_space.texts)
    )
