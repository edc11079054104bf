"""Device-resident target-embedding index, on one GPU or row-sharded over
a grid of devices (port of ``sse_tpu/index/sharded_index.py``).

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
legacy Orbax layout.

With a ``mesh`` (``sse_tpu_torch.parallel.make_mesh``) the rows are split
over 'model' into equal blocks, each on every device of its grid column
(replicated over 'data'): ``emb`` is then a ``parallel.RowShards``. The
padding rounds to the shard count (``_padded_rows``); ``add`` and
``delete`` write across block boundaries, a row moved by ``delete`` may
cross devices (or processes); ``save`` writes one
``emb_r{row0:012d}.npy`` a block, each process its own, and rank 0
``docs.tsv`` and ``sidecar.json`` after a barrier; ``load`` reads any
npy-v1 layout onto a grid.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import shutil
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sse_tpu_torch.data.corpus import TargetSpace
from sse_tpu_torch.models import sse
from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
from sse_tpu_torch.parallel import distributed
from sse_tpu_torch.parallel.mesh import Mesh, RowShards, replicate
from sse_tpu_torch.utils import graphs
from sse_tpu_torch.utils.graphs import GraphPool, GraphStats, Program
from sse_tpu_torch.utils.profiling import span

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
    emb: torch.Tensor | RowShards  # [T_pad, D] on the serving device, or over mesh
    num_real: int  # first num_real rows are valid
    ids: List[str]
    texts: List[str]
    mesh: Optional[Mesh] = None
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

    def valid_mask(self) -> torch.Tensor:
        """[T_pad] bool on the index's (first) device: False on padding
        rows."""
        return torch.arange(self.padded_size, device=self.emb.device) < self.num_real

    def lookup(self, rows: Sequence[int]) -> List[Tuple[str, str]]:
        """Global row indices → (target_id, target_text)."""
        return [(self.ids[r], self.texts[r]) for r in rows]

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
        if self.mesh is not None:
            _write_rows(self.emb, self.num_real, update)
        else:
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
        if self.mesh is not None:
            return self._delete_sharded(rows)
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

    def _delete_sharded(self, rows: List[int]) -> int:
        """``delete`` on a grid: the swaps run on the host over row
        numbers, then every row that moved is copied from the old blocks
        (across devices, or from the process that holds it) into copies
        of the blocks it lands in, and the vacated rows are zeroed. The
        old blocks stay as they were for readers of the old snapshot."""
        old = self.emb
        nr = self.num_real
        src = list(range(nr))  # src[i]: the old row that ends at row i
        new_ids = list(self.ids)
        new_texts = list(self.texts)
        end = nr
        for r in sorted(rows, reverse=True):
            end -= 1
            if end > r:
                src[r] = src[end]
                new_ids[r] = new_ids[end]
                new_texts[r] = new_texts[end]
            del new_ids[end]
            del new_texts[end]
        dest = [i for i in range(end) if src[i] != i]
        t = old.rows_per_shard
        touched = {i // t for i in dest} | set(range(end // t, -(-nr // t)))
        blocks = [
            {dev: b.clone() for dev, b in copies.items()} if s in touched else copies
            for s, copies in enumerate(old.blocks)
        ]
        moved = _gather_rows(old, [src[i] for i in dest])
        for s in touched:
            mine = [j for j, i in enumerate(dest) if i // t == s]
            at = torch.tensor([dest[j] - s * t for j in mine], dtype=torch.long)
            for dev, b in blocks[s].items():
                if mine:
                    b[at.to(dev)] = moved[mine].to(dev)
                b[max(end - s * t, 0) : max(min(nr - s * t, t), 0)] = 0
        self.emb = RowShards(self.mesh, blocks, old.shape, old.dtype)
        self.num_real = end
        self.ids = new_ids
        self.texts = new_texts
        self._publish()
        return self.num_real

    # ------------------------------------------------------------ persist
    def save(self, directory: str) -> None:
        """Write the npy-v1 layout: ``emb_r{row0:012d}.npy`` (bf16 as
        uint16 bits), ``docs.tsv``, ``sidecar.json``. One tensor: one file
        of all T_pad rows. On a grid: one file a row block, written by the
        process that owns the block (``Mesh.owner``); rank 0 writes
        ``docs.tsv`` and the sidecar once every block is on disk (a
        barrier), and no process returns before they are (a second one).
        Assumes a directory that every process sees. Rows reach the host
        in 16 MiB chunks written straight into a memmapped .npy, so host
        memory stays at one chunk. Files the new sidecar no longer names
        (a legacy Orbax ``emb/``, other ``emb_*.npy``) are removed."""
        directory = os.path.abspath(directory)
        os.makedirs(directory, exist_ok=True)
        emb, num_real, ids, texts = self.pub
        if self.mesh is None:
            blocks = {0: emb}
            mine = [0]
        else:
            t = emb.rows_per_shard
            blocks = {s * t: emb.block(s) if self.mesh.owner(s) == self.mesh.rank else None
                      for s in range(len(emb.blocks))}
            mine = [r for r, b in blocks.items() if b is not None]
        for row0 in mine:
            _write_npy(os.path.join(directory, f"emb_r{row0:012d}.npy"), blocks[row0])
        multi = self.mesh is not None and self.mesh.multi_process
        if multi:
            distributed.barrier()  # every block on disk before the sidecar names it
        if not multi or self.mesh.rank == 0:
            _write_meta(directory, num_real, ids, texts, tuple(emb.shape), emb.dtype,
                        sorted(blocks))
        if multi:
            distributed.barrier()

    @classmethod
    def load(cls, directory: str, device: torch.device | str | Mesh = "cuda") -> "ShardedIndex":
        """Read an npy-v1 index (written by either package, any number of
        shard files) onto ``device``, or onto a grid when ``device`` is a
        ``Mesh`` (each process reads the blocks of its own grid columns).
        Raises on the legacy Orbax layout and on a docs.tsv whose row count
        is not the sidecar's ``num_real``."""
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
        shape = tuple(side["shape"])
        parts = [
            (s["row0"], np.load(os.path.join(directory, s["file"]), mmap_mode="r"))
            for s in sorted(side["shards"], key=lambda s: s["row0"])
        ]
        row = sum(p.shape[0] for _, p in parts)
        if row != shape[0]:
            raise ValueError(f"corrupt index at {directory}: shards hold {row} of {shape[0]} rows")
        mesh = device if isinstance(device, Mesh) else None
        if mesh is None:
            emb = torch.empty(shape, dtype=dtype, device=device)
            _read_rows(parts, 0, emb)
        else:
            shards = mesh.shape["model"]
            if shape[0] % shards:
                raise ValueError(f"{shape[0]} index rows do not split into {shards} blocks")
            t = shape[0] // shards
            blocks = []
            for s in range(shards):
                devs = mesh.column_devices(s)
                copies = {}
                if devs:
                    first = torch.empty((t, shape[1]), dtype=dtype, device=devs[0])
                    _read_rows(parts, s * t, first)
                    copies = {dev: first if dev == devs[0] else first.to(dev, copy=True)
                              for dev in devs}
                blocks.append(copies)
            emb = RowShards(mesh, blocks, shape, dtype)
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
        return cls(emb=emb, num_real=side["num_real"], ids=ids, texts=texts, mesh=mesh)

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
    def import_tsv(cls, path: str, device: torch.device | str | Mesh = "cuda") -> "ShardedIndex":
        """Read a targetEncodingIndex.tsv into a float32 index on
        ``device``, or on a grid when ``device`` is a ``Mesh``."""
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
        if isinstance(device, Mesh):
            return from_embeddings(np.stack(rows), ids, texts, mesh=device)
        return from_embeddings(np.stack(rows), ids, texts, device=device)


def _write_npy(path: str, emb: torch.Tensor) -> None:
    """``emb`` [rows, D] into a .npy (bf16 as uint16 bits), in 16 MiB
    chunks through a memmap."""
    rows, dim = emb.shape
    as_bits = emb.dtype == torch.bfloat16
    out = np.lib.format.open_memmap(
        path, mode="w+", dtype=np.uint16 if as_bits else _DTYPE_NAME[emb.dtype], shape=(rows, dim),
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


def _write_meta(directory: str, num_real: int, ids, texts, shape, dtype, row0s) -> None:
    """docs.tsv and sidecar.json of an index whose shard files start at
    ``row0s``; removes the files the sidecar does not name."""
    names = [f"emb_r{r:012d}.npy" for r in row0s]
    with open(os.path.join(directory, "docs.tsv"), "w", encoding="utf-8", newline="\n") as f:
        for tid, txt in zip(ids[:num_real], texts[:num_real]):
            f.write(f"{_esc(tid)}\t{_esc(txt)}\n")
    with open(os.path.join(directory, "sidecar.json"), "w", encoding="utf-8") as f:
        json.dump(
            {
                "format": "npy-v1",
                "num_real": num_real,
                "shape": list(shape),
                "dtype": _DTYPE_NAME[dtype],
                "shards": [{"file": n, "row0": r} for n, r in zip(names, row0s)],
            },
            f,
        )
    shutil.rmtree(os.path.join(directory, "emb"), ignore_errors=True)
    for path in glob.glob(os.path.join(directory, "emb_*.npy")):
        if os.path.basename(path) not in names:
            os.unlink(path)


def _read_rows(parts, lo: int, out: torch.Tensor) -> None:
    """Fill ``out`` [n, D] with rows [lo, lo + n) of the index whose shard
    files are ``parts`` ((row0, memmapped array), by row0), 16 MiB at a
    time (bf16 files hold uint16 bits)."""
    hi = lo + out.shape[0]
    for row0, part in parts:
        a, b = max(lo, row0), min(hi, row0 + part.shape[0])
        step = max(1, _SAVE_CHUNK_BYTES // max(1, part.shape[1] * part.itemsize))
        for c in range(a, b, step):
            chunk = np.array(part[c - row0 : min(b, c + step) - row0])  # a writable copy
            if out.dtype == torch.bfloat16:
                t = torch.from_numpy(chunk.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(chunk)
            out[c - lo : c - lo + t.shape[0]] = t.to(out.device)


def _write_rows(emb: RowShards, at: int, rows: torch.Tensor) -> None:
    """Write ``rows`` at global row ``at`` into every copy of the blocks
    they fall in (in place)."""
    t = emb.rows_per_shard
    hi = at + rows.shape[0]
    for s in range(at // t, -(-hi // t)):
        a, b = max(at, s * t), min(hi, (s + 1) * t)
        for dev, blk in emb.blocks[s].items():
            blk[a - s * t : b - s * t] = rows[a - at : b - at].to(dev)


def _gather_rows(emb: RowShards, rows: List[int]) -> torch.Tensor:
    """Global ``rows`` of a grid index, [n, D] on its first device. Across
    processes each row comes from the rank that owns its block
    (``distributed.all_gather``; bf16 travels as its int16 bits)."""
    t = emb.rows_per_shard
    mesh = emb.mesh
    out = torch.zeros((len(rows), emb.shape[1]), dtype=emb.dtype, device=emb.device)
    for s in sorted({r // t for r in rows}):
        if mesh.owner(s) != mesh.rank:
            continue
        sel = [j for j, r in enumerate(rows) if r // t == s]
        local = torch.tensor([rows[j] - s * t for j in sel], dtype=torch.long)
        blk = emb.block(s)
        out[sel] = blk[local.to(blk.device)].to(out.device)
    if not mesh.multi_process or not rows:
        return out
    bits = out.view(torch.int16) if out.dtype == torch.bfloat16 else out
    every = distributed.all_gather(bits)
    owner = torch.tensor([mesh.owner(r // t) for r in rows], dtype=torch.long, device=out.device)
    picked = every[owner, torch.arange(len(rows), device=out.device)]
    return picked.view(torch.bfloat16) if out.dtype == torch.bfloat16 else picked


def _shard_count(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.shape["model"]


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
    mesh: Optional[Mesh] = None,
) -> ShardedIndex:
    """Wrap embeddings [T, D] (numpy or tensor) into a padded index on
    ``device``, or row-sharded over ``mesh`` (``device`` unused; across
    processes every rank passes the same rows and keeps its own blocks)."""
    emb = torch.as_tensor(emb).float()
    t, d = emb.shape
    padded = torch.zeros((_padded_rows(t, capacity, _shard_count(mesh)), d), dtype=torch.float32)
    padded[:t] = emb.cpu()
    if mesh is not None:
        return ShardedIndex(
            emb=RowShards.from_tensor(padded, mesh, dtype, lambda x: quantize_rows(x, dtype)),
            num_real=t, ids=list(ids), texts=list(texts), mesh=mesh,
        )
    return ShardedIndex(
        emb=quantize_rows(padded.to(device), dtype),
        num_real=t,
        ids=list(ids),
        texts=list(texts),
    )


def _params_device(params) -> torch.device:
    return params["src_tower"]["embed"].device


class _ChunkEncoder:
    """``build_index``'s program on one device: fixed token buffers for a
    chunk of ``s`` x ``eff_bs`` documents, and ``encode_chunk`` (a
    ``Program``: a CUDA graph with a ``pool``) turning them into [s·eff_bs,
    D] quantized rows, the counterpart of JAX's ``encode_chunk``."""

    def __init__(self, params, model_cfg: SSEConfig, dev: torch.device, s: int, eff_bs: int,
                 length: int, dtype: torch.dtype, pool: Optional[GraphPool],
                 graph_stats: Optional[GraphStats]) -> None:
        self.tok_in = torch.empty((s, eff_bs, length), dtype=torch.int32, device=dev)
        self.len_in = torch.empty((s, eff_bs), dtype=torch.int32, device=dev)
        self.pinned = dev.type == "cuda"

        def encode_chunk():  # the counterpart of JAX's lax.map over sub-batches
            out = torch.cat([sse.target_embeddings(params, model_cfg, tokens=self.tok_in[i],
                                                   lengths=self.len_in[i]) for i in range(s)])
            return quantize_rows(out, dtype)

        self.program = Program(encode_chunk, pool, graph_stats, (s, eff_bs, length))

    def stage(self, tb: np.ndarray, lb: np.ndarray) -> None:
        """One padded chunk's tokens (host arrays) into the buffers, up
        once (pinned, asynchronously, on a card)."""
        for buf_in, a in ((self.tok_in, tb), (self.len_in, lb)):
            host = torch.from_numpy(np.ascontiguousarray(a)).view(buf_in.shape)
            buf_in.copy_(host.pin_memory() if self.pinned else host, non_blocking=self.pinned)

    def __call__(self) -> torch.Tensor:
        """The rows of the staged chunk."""
        return self.program()


def _encode_chunks(toks, lens, chunk_docs: int, progress,
                   encoder_for: Callable[[int, int], Optional[_ChunkEncoder]],
                   write: Callable[[int, torch.Tensor], None]) -> None:
    """``build_index``'s loop: the documents in chunks of ``chunk_docs``,
    the tail chunk padded with zero tokens and length 1; each chunk goes
    through ``encoder_for(lo, hi)`` (None: no block of this process holds
    it), and its real rows to ``write(lo, rows)``. ``progress(hi, T)``
    once a chunk, as JAX calls it. Spans: ``index.stage`` (a chunk's host
    arrays sliced, padded and uploaded), ``index.encode`` (the chunk
    program's call and the rows' write)."""
    t, l = toks.shape
    with torch.no_grad():
        for lo in range(0, t, chunk_docs):
            hi = min(lo + chunk_docs, t)
            encoder = encoder_for(lo, hi)
            if encoder is not None:
                with span("index.stage"):
                    tb = np.asarray(toks[lo:hi], np.int32)
                    lb = np.asarray(lens[lo:hi], np.int32)
                    if hi - lo < chunk_docs:  # pad the tail chunk
                        pad = chunk_docs - (hi - lo)
                        tb = np.concatenate([tb, np.zeros((pad, l), np.int32)])
                        lb = np.concatenate([lb, np.ones((pad,), np.int32)])
                    encoder.stage(tb, lb)
                with span("index.encode"):
                    write(lo, encoder()[: hi - lo])  # the padding rows stay zero
            if progress:
                progress(hi, t)


def build_index(
    params,
    model_cfg: SSEConfig,
    target_space: TargetSpace,
    batch_size: int = 256,
    dtype: torch.dtype = torch.float32,
    capacity: Optional[int] = None,
    mesh: Optional[Mesh] = None,
    cp_shards: int = 0,
    *,
    progress: Optional[Callable[[int, int], None]] = None,
    chunk_batches: int = 64,
    capture: bool = True,
    graph_stats: Optional[GraphStats] = None,
) -> ShardedIndex:
    """Encode the whole target space into an index on the params' device,
    or row-sharded over ``mesh``.

    SOURCE_ENCODER_ONLY: the learned table is the index. Tower modes, as
    the JAX build: the documents go in chunks of ``chunk_batches``
    sub-batches of ``min(batch_size, T rounded up to 8)`` rows (a corpus
    smaller than a full chunk takes fewer sub-batches), the tail chunk
    padded with zero tokens and length 1; rows in ``[num_targets, T_pad)``
    stay zero, the tail chunk's padding rows too. ``progress(hi, T)`` is
    called once a chunk. Host spans (``utils.profiling.span``):
    ``index.build`` the call, ``index.stage`` and ``index.encode`` each
    chunk's, ``index.publish`` the ``ShardedIndex`` made.

    Encoding a chunk is one fixed-shape program, the counterpart of JAX's
    ``encode_chunk``: the sub-batches' target-tower encodes and the
    quantization into one ``[chunk, D]`` buffer (``_ChunkEncoder``). On a
    card (with ``capture``, the default) it is one CUDA graph a build and
    card (``utils.graphs.Program``): the first chunk's dispatch on a card
    is the capture's warm-up, every later one a replay (``graph_stats``
    counts them); a capture that fails raises. ``capture=False`` runs it
    eagerly. Each chunk's tokens go up once, and its rows reach each copy
    of a row block in one device copy.

    On a grid (``mesh``, ``cp_shards`` ≤ 1) each card has its own program
    and memory pool. A chunk is encoded once, on a card of the first row
    block it lands in (a process encodes only the chunks that reach its
    own blocks), and its real rows are written into every copy of the
    blocks it spans. JAX replicates ``encode_chunk`` on every device
    (``out_shardings=rep``, ``sse_tpu/index/sharded_index.py:664``);
    encoding once gives the same rows, bit for bit the one-device
    build's, as the chunks have the same shape.

    ``cp_shards`` > 1 (a transformer tower with the mean readout) stays
    eager, one ``batch_size`` batch at a time: one context-parallel
    encode spans several cards inside one op sequence, so no graph of one
    card holds it. The target tower encodes each batch context-parallel
    on its own ``{'seq': cp_shards}`` grid of this process's devices
    (``parallel.context.local_cp_mesh`` beside the params' device), the
    token width padded to a multiple of the shards; the encoded rows are
    then written into the index, on ``mesh`` where there is one, so the two
    placements compose (``sse_tpu/index/sharded_index.py:614-646``)."""
    with span("index.build"):
        device = _params_device(params)
        if model_cfg.mode == NetworkMode.SOURCE_ENCODER_ONLY:
            with torch.no_grad():
                emb = sse.target_embeddings(params, model_cfg)
            return from_embeddings(
                emb[: target_space.num_targets], target_space.ids, target_space.texts,
                dtype=dtype, capacity=capacity, device=device, mesh=mesh,
            )
        toks, lens = target_space.tokens, target_space.lengths
        t = toks.shape[0]
        rows = _padded_rows(t, capacity, _shard_count(mesh))
        eff_bs = min(batch_size, _round_up(t, 8))
        s = max(1, min(chunk_batches, -(-t // eff_bs)))
        chunk_docs = s * eff_bs
        d = model_cfg.encoding_dim
        if mesh is not None:
            shards = mesh.shape["model"]
            blocks = [
                {dev: torch.zeros((rows // shards, d), dtype=dtype, device=dev)
                 for dev in mesh.column_devices(c)}
                for c in range(shards)
            ]
            buf = RowShards(mesh, blocks, (rows, d), dtype)
        else:
            buf = torch.zeros((rows, d), dtype=dtype, device=device)
        if cp_shards <= 1:
            copies = {device: params} if mesh is None else replicate(params, mesh)
            encoders = {}

            def encoder_for(lo: int, hi: int) -> Optional[_ChunkEncoder]:
                dev = device
                if mesh is not None:
                    t_local = buf.rows_per_shard
                    mine = [c for c in range(lo // t_local, -(-hi // t_local)) if buf.blocks[c]]
                    if not mine:
                        return None
                    dev = mesh.column_devices(mine[0])[0]
                if dev not in encoders:
                    encoders[dev] = _ChunkEncoder(copies[dev], model_cfg, dev, s, eff_bs,
                                                  toks.shape[1], dtype,
                                                  graphs.pool_for(dev, capture), graph_stats)
                return encoders[dev]

            def write(lo: int, out: torch.Tensor) -> None:
                if mesh is None:
                    buf[lo : lo + out.shape[0]].copy_(out)
                else:
                    _write_rows(buf, lo, out)

            _encode_chunks(toks, lens, chunk_docs, progress, encoder_for, write)
            with span("index.publish"):
                return ShardedIndex(emb=buf, num_real=t, ids=list(target_space.ids),
                                    texts=list(target_space.texts), mesh=mesh)
        from sse_tpu_torch.parallel.context import local_cp_mesh, make_cp_encoder

        tower = "tgt_tower" if model_cfg.mode == NetworkMode.DUAL_ENCODER else "src_tower"
        cp_enc = make_cp_encoder(getattr(model_cfg, tower), local_cp_mesh(cp_shards, device))
        l_cp = -(-toks.shape[1] // cp_shards) * cp_shards  # token width a shard count divides
        with torch.no_grad():
            for lo in range(0, t, batch_size):
                hi = min(lo + batch_size, t)
                dev = device
                mine = True
                if mesh is not None:
                    t_local = buf.rows_per_shard
                    mine = [c for c in range(lo // t_local, -(-hi // t_local)) if buf.blocks[c]]
                    if mine:
                        dev = mesh.column_devices(mine[0])[0]
                if mine:
                    tb = torch.from_numpy(np.ascontiguousarray(toks[lo:hi])).to(dev)
                    lb = torch.from_numpy(np.ascontiguousarray(lens[lo:hi])).to(dev)
                    tb = torch.nn.functional.pad(tb, (0, l_cp - tb.shape[1]))
                    out = quantize_rows(cp_enc(params[tower], tb, lb).to(dev), dtype)
                    if mesh is None:
                        buf[lo:hi] = out
                    else:
                        _write_rows(buf, lo, out)
                if progress and (hi == t or hi % chunk_docs == 0):  # the chunks' ends
                    progress(hi, t)
        with span("index.publish"):
            return ShardedIndex(
                emb=buf, num_real=t, ids=list(target_space.ids), texts=list(target_space.texts),
                mesh=mesh,
            )
