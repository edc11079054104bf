"""Device-resident target-embedding index on one GPU (port of
``sse_tpu/index/sharded_index.py``).

Same geometry and invariants as the JAX index: ``[T_pad, D]`` rows,
L2-normalized, stored as float32, bfloat16 or int8 (symmetric 127-scale);
rows in ``[num_real, T_pad)`` are ZERO vectors; scoring masks them by the
runtime ``num_real``. ``pub`` publishes ``(emb, num_real, ids, texts)`` as
one attribute so a concurrent query sees the fully-old or the fully-new
index.

Persistence is the JAX package's ``npy-v1`` layout, so an index saved by
either package loads in the other: ``emb_r{row0:012d}.npy`` (bf16 stored as
its uint16 bits), ``docs.tsv`` (one escaped ``id\ttext`` line per real
row) and ``sidecar.json``. ``export_tsv``/``import_tsv`` speak the
reference's ``targetEncodingIndex.tsv``. Not ported (ROADMAP.md): the
legacy Orbax layout, and sharding over several devices.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import shutil
from typing import List, Optional, Sequence

import numpy as np
import torch

from sse_tpu_torch.data.corpus import TargetSpace
from sse_tpu_torch.models import sse
from sse_tpu_torch.models.sse import NetworkMode, SSEConfig

INT8_SCALE = 127  # L2-normalized rows live in [-1, 1]; symmetric int8


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _esc(s: str) -> str:
    """docs.tsv field escape (``sse_tpu/index/sharded_index.py:_esc``):
    backslash, tab, newline and carriage return, so one row stays one
    line whatever a live add() put in it."""
    return s.replace("\\", "\\\\").replace("\t", "\\t").replace("\n", "\\n").replace("\r", "\\r")


def _unesc(s: str) -> str:
    out, i, n = [], 0, len(s)
    while i < n:
        c = s[i]
        if c == "\\" and i + 1 < n:
            nxt = s[i + 1]
            out.append({"t": "\t", "n": "\n", "r": "\r", "\\": "\\"}.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


# sidecar.json's dtype names (numpy's, as the JAX package writes them)
_DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.int8: "int8"}
_NAME_DTYPE = {v: k for k, v in _DTYPE_NAME.items()}
_SAVE_CHUNK_BYTES = 16 << 20  # device→host copy per chunk: peak host memory


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
    def dim(self) -> int:
        return int(self.emb.shape[1])

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

    # ------------------------------------------------------------ persist
    def save(self, directory: str) -> None:
        """Write the npy-v1 layout: ``emb_r000000000000.npy`` (all T_pad
        rows; bf16 as uint16 bits), ``docs.tsv``, ``sidecar.json``. Rows
        reach the host in 16 MiB chunks written straight into a memmapped
        .npy, so host memory stays at one chunk. Files the new sidecar no
        longer names (a legacy Orbax ``emb/``, other ``emb_*.npy``) are
        removed."""
        directory = os.path.abspath(directory)
        os.makedirs(directory, exist_ok=True)
        emb, num_real, ids, texts = self.pub
        rows, dim = emb.shape
        as_bits = emb.dtype == torch.bfloat16
        name = "emb_r000000000000.npy"
        out = np.lib.format.open_memmap(
            os.path.join(directory, name), mode="w+",
            dtype=np.uint16 if as_bits else _DTYPE_NAME[emb.dtype], shape=(rows, dim),
        )
        step = max(1, _SAVE_CHUNK_BYTES // (dim * emb.element_size()))
        for lo in range(0, rows, step):
            part = emb[lo : lo + step]
            if as_bits:
                part = part.view(torch.int16)
            part = part.cpu().numpy()
            out[lo : lo + step] = part.view(np.uint16) if as_bits else part
        out.flush()
        del out
        with open(os.path.join(directory, "docs.tsv"), "w", encoding="utf-8", newline="\n") as f:
            for tid, txt in zip(ids[:num_real], texts[:num_real]):
                f.write(f"{_esc(tid)}\t{_esc(txt)}\n")
        with open(os.path.join(directory, "sidecar.json"), "w", encoding="utf-8") as f:
            json.dump(
                {
                    "format": "npy-v1",
                    "num_real": num_real,
                    "shape": [rows, dim],
                    "dtype": _DTYPE_NAME[emb.dtype],
                    "shards": [{"file": name, "row0": 0}],
                },
                f,
            )
        shutil.rmtree(os.path.join(directory, "emb"), ignore_errors=True)
        for path in glob.glob(os.path.join(directory, "emb_*.npy")):
            if os.path.basename(path) != name:
                os.unlink(path)

    @classmethod
    def load(cls, directory: str, device: torch.device | str = "cuda") -> "ShardedIndex":
        """Read an npy-v1 index (written by either package) onto
        ``device``. Raises on the legacy Orbax layout and on a docs.tsv
        whose row count is not the sidecar's ``num_real``."""
        directory = os.path.abspath(directory)
        with open(os.path.join(directory, "sidecar.json"), "r", encoding="utf-8") as f:
            side = json.load(f)
        if side.get("format") != "npy-v1":
            raise ValueError(
                f"{directory}: legacy Orbax index layout (sidecar.json has no "
                '"format": "npy-v1"); sse_tpu_torch reads only npy-v1. Load it '
                "with sse_tpu's ShardedIndex.load and save it again."
            )
        dtype = _NAME_DTYPE[side["dtype"]]
        emb = torch.empty(tuple(side["shape"]), dtype=dtype, device=device)
        row = 0
        for shard in sorted(side["shards"], key=lambda s: s["row0"]):
            part = np.load(os.path.join(directory, shard["file"]), mmap_mode="r")
            step = max(1, _SAVE_CHUNK_BYTES // max(1, part.shape[1] * part.itemsize))
            for lo in range(0, part.shape[0], step):
                chunk = np.array(part[lo : lo + step])  # a writable copy off the memmap
                if dtype == torch.bfloat16:
                    t = torch.from_numpy(chunk.view(np.int16)).view(torch.bfloat16)
                else:
                    t = torch.from_numpy(chunk)
                at = shard["row0"] + lo
                emb[at : at + t.shape[0]] = t.to(device)
            row += part.shape[0]
        if row != emb.shape[0]:
            raise ValueError(f"corrupt index at {directory}: shards hold {row} of {emb.shape[0]} rows")
        ids: List[str] = []
        texts: List[str] = []
        # newline="\n": a raw "\r" in an old unescaped file stays in its field
        with open(os.path.join(directory, "docs.tsv"), "r", encoding="utf-8", newline="\n") as f:
            for line in f:
                tid, _, txt = line.rstrip("\n").partition("\t")
                ids.append(_unesc(tid))
                texts.append(_unesc(txt))
        if len(ids) != side["num_real"]:
            raise ValueError(
                f"corrupt index at {directory}: docs.tsv has {len(ids)} rows but "
                f"sidecar num_real={side['num_real']}"
            )
        return cls(emb=emb, num_real=side["num_real"], ids=ids, texts=texts)

    # -------------------------------------------------- reference TSV compat
    def export_tsv(self, path: str) -> None:
        """Write the reference's targetEncodingIndex.tsv (``id\ttext\t``
        space-joined ``%.6f`` floats); an int8 index exports dequantized
        rows (row / 127)."""
        emb = self.emb[: self.num_real].float().cpu().numpy()
        if self.emb.dtype == torch.int8:
            emb = emb / INT8_SCALE
        with open(path, "w", encoding="utf-8") as f:
            for i in range(self.num_real):
                vec = " ".join(f"{v:.6f}" for v in emb[i])
                f.write(f"{self.ids[i]}\t{self.texts[i]}\t{vec}\n")

    @classmethod
    def import_tsv(cls, path: str, device: torch.device | str = "cuda") -> "ShardedIndex":
        """Read a targetEncodingIndex.tsv into a float32 index."""
        ids, texts, rows = [], [], []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                tid, text, vec = line.split("\t")
                ids.append(tid)
                texts.append(text)
                rows.append(np.asarray(vec.split(" "), dtype=np.float32))
        return from_embeddings(np.stack(rows), ids, texts, device=device)


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
    device: torch.device | str = "cuda",
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
