"""The ('data', 'model') grid of devices and the placement helpers (port
of ``sse_tpu/parallel/mesh.py``).

Layout policy, as in the JAX package: a query batch is split over
'data' (each data replica serves its slice of the batch); the index rows
are split over 'model' into equal row blocks, one a column of the grid,
replicated over 'data'; the tower params are replicated on every device.

A device may appear more than once in a grid. Then several shards share
one card, and their kernel launches run one after another on it (in one
CUDA graph of the served query, ``entries_by_device``): this is how one
card runs a (2, 2) or (1, 4) grid in ``chip_smoke.py``, and the CPU
tests a grid of eight CPU entries, as JAX's eight fake CPU devices do in
``tests/conftest.py``. It checks the sharded path; it is not a
speed-up.

Across processes (``parallel.distributed.initialize``) the grid is
global, as a JAX mesh is after ``jax.distributed.initialize``: every
entry records the rank of the process that owns it, the device names of
other ranks are labels only, and each process touches only its own
entries.

A train state on a grid (``place``, the counterpart of JAX's
``jax.device_put(state, param_shardings(mesh, state))``): every
``target_table`` leaf (the params', the Adam moments' and the EMA copy's)
is a ``RowShards`` of equal row blocks over 'model', each block on every
device of its column; every other leaf is a ``Replicated`` copy on each
of this process's devices. A table whose rows do not divide by 'model'
raises ValueError, as ``jax.device_put`` does. ``gather`` assembles a
placed tree whole on one device. A batch is split over 'data' in grid
order (``batch_rows``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sse_tpu_torch.parallel import distributed

AXES = ("data", "model")


def _normalized(device) -> torch.device:
    """A ``torch.device`` with its index (``cuda`` → ``cuda:<current>``),
    so that equal cards compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices`` [data, model] of ``torch.device``; ``ranks`` [data,
    model], the process that owns each entry; ``rank``, this process."""

    devices: np.ndarray
    ranks: np.ndarray
    rank: int = 0

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def multi_process(self) -> bool:
        return bool((self.ranks != self.ranks.flat[0]).any())

    def is_local(self, d: int, s: int) -> bool:
        return int(self.ranks[d, s]) == self.rank

    def column_devices(self, s: int) -> List[torch.device]:
        """This process's distinct devices of column ``s``, in grid order."""
        out: List[torch.device] = []
        for d in range(self.devices.shape[0]):
            if self.is_local(d, s) and self.devices[d, s] not in out:
                out.append(self.devices[d, s])
        return out

    @property
    def local_devices(self) -> List[torch.device]:
        """This process's distinct devices, in grid order."""
        return list(self.entries_by_device())

    def entries_by_device(self) -> Dict[torch.device, List[Tuple[int, int]]]:
        """This process's grid entries (d, s) grouped by distinct device:
        device → its entries in grid order, the devices in grid order. A
        card named more than once holds every entry that names it."""
        out: Dict[torch.device, List[Tuple[int, int]]] = {}
        for (d, s), dev in np.ndenumerate(self.devices):
            if self.is_local(d, s):
                out.setdefault(dev, []).append((d, s))
        return out

    def owner(self, s: int) -> int:
        """The rank that holds column ``s`` for the others (the one of its
        first entry): it writes the column's file and serves its rows."""
        return int(self.ranks[0, s])


def _visible_cards() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device (pass devices=... to build a grid of others)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    data: int = -1,
    model: int = 1,
    devices: Optional[Sequence[Any]] = None,
) -> Mesh:
    """('data', 'model') grid. ``data=-1`` takes every remaining device; a
    count that ``model`` does not divide raises, and devices past
    ``data · model`` are left out (JAX's rules). ``devices``: this
    process's devices, every visible card when None (raises where there is
    none). In a process group of several ranks the grid holds every
    rank's devices, in rank order."""
    if devices is None:
        cards = _visible_cards()
        local = [distributed.local_device()] if distributed.world_size() > 1 else cards
    else:
        local = list(devices)
    local = [_normalized(d) for d in local]
    if distributed.world_size() > 1:
        per_rank = distributed.all_gather_object([str(d) for d in local])
        flat = [(torch.device(d), r) for r, names in enumerate(per_rank) for d in names]
    else:
        flat = [(d, 0) for d in local]
    n = len(flat)
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data < 1 or model < 1 or data * model > n:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} devices, have {n}")
    flat = flat[: data * model]
    devs = np.empty((data, model), dtype=object)
    ranks = np.empty((data, model), dtype=np.int64)
    for i, (dev, r) in enumerate(flat):
        devs[divmod(i, model)] = dev
        ranks[divmod(i, model)] = r
    return Mesh(devs, ranks, distributed.rank())


class Replicated(dict):
    """A params pytree copied once to each of a grid's distinct devices
    (``replicate``): device → pytree."""


def _to(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device) if torch.is_tensor(tree) else tree


def replicate(params: Any, mesh: Mesh) -> Replicated:
    """``params`` on each of this process's distinct devices of ``mesh``
    (a tensor already on a device is not copied there). A ``Replicated``
    given is returned as it is."""
    if isinstance(params, Replicated):
        return params
    return Replicated({dev: _to(params, dev) for dev in mesh.local_devices})


class RowShards:
    """A [rows, D] matrix split into ``mesh.shape['model']`` equal row
    blocks: block s lies on each of this process's distinct devices of
    grid column s (replicated over 'data'). It stands where a single-card
    index holds one tensor: ``shape``, ``dtype``, ``device`` (this
    process's first device), ``element_size()``, and row slices
    (``x[lo:hi]``, gathered on ``device``)."""

    def __init__(self, mesh: Mesh, blocks: List[Dict[torch.device, torch.Tensor]],
                 shape: Sequence[int], dtype: torch.dtype):
        self.mesh = mesh
        self.blocks = blocks
        self.shape = torch.Size(shape)
        self.dtype = dtype

    @classmethod
    def from_tensor(cls, x: torch.Tensor, mesh: Mesh, dtype: Optional[torch.dtype] = None,
                    fn=None) -> "RowShards":
        """Split ``x`` (any device) into the grid's row blocks, each copied
        to its devices and passed through ``fn`` (e.g. the index's
        quantization to ``dtype``) if given. Rows must divide evenly."""
        shards = mesh.shape["model"]
        if x.shape[0] % shards:
            raise ValueError(f"{x.shape[0]} rows do not split into {shards} equal blocks")
        t = x.shape[0] // shards
        blocks = []
        for s in range(shards):
            copies = {}
            for dev in mesh.column_devices(s):
                part = x[s * t : (s + 1) * t].to(dev, copy=True)
                copies[dev] = part if fn is None else fn(part)
            blocks.append(copies)
        return cls(mesh, blocks, x.shape, dtype or x.dtype)

    @property
    def rows_per_shard(self) -> int:
        return self.shape[0] // len(self.blocks)

    @property
    def device(self) -> torch.device:
        return self.mesh.local_devices[0]

    def element_size(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    def block(self, s: int, device: Optional[torch.device] = None) -> torch.Tensor:
        """Block ``s`` on ``device`` (its first copy when None); raises if
        this process holds no copy there."""
        copies = self.blocks[s]
        if not copies:
            raise ValueError(f"row block {s} lies on another process")
        return next(iter(copies.values())) if device is None else copies[device]

    def __getitem__(self, key) -> torch.Tensor:
        if not isinstance(key, slice) or key.step not in (None, 1):
            raise TypeError("RowShards takes row slices x[lo:hi] only")
        lo, hi, _ = key.indices(self.shape[0])
        t = self.rows_per_shard
        parts = []
        for s in range(lo // t, -(-hi // t) if hi > lo else lo // t):
            a, b = max(lo, s * t) - s * t, min(hi, (s + 1) * t) - s * t
            if b > a:
                parts.append(self.block(s)[a:b].to(self.device))
        if not parts:
            return torch.empty((0, self.shape[1]), dtype=self.dtype, device=self.device)
        return torch.cat(parts)


# ------------------------------------------------- a train state on a grid
ROW_SHARDED = ("target_table",)  # the leaves split over 'model' (param_shardings)


def param_shardings(tree: Any) -> Any:
    """``tree``'s structure with "model" at every ``target_table`` leaf
    (rows over 'model') and None at every other (replicated): the rule of
    JAX's ``param_shardings``, for ``place``."""

    def walk(t, key):
        if isinstance(t, dict) and not isinstance(t, Replicated):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, key) for v in t)
        return "model" if key in ROW_SHARDED else None

    return walk(tree, None)


def is_placed(leaf: Any) -> bool:
    return isinstance(leaf, (Replicated, RowShards))


def place(tree: Any, mesh: Mesh) -> Any:
    """``tree`` (a params-like pytree of tensors, or None) on ``mesh`` by
    ``param_shardings``: row-sharded leaves become ``RowShards`` (ValueError
    where the rows do not divide by 'model'), the others ``Replicated``
    copies on each of this process's devices. Leaves already placed stay
    as they are."""
    if tree is None:
        return None

    def walk(t, rule):
        if is_placed(t):
            return t
        if isinstance(t, dict):
            return {k: walk(v, rule[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, r) for v, r in zip(t, rule))
        if rule == "model":
            return RowShards.from_tensor(t.detach(), mesh)
        return Replicated({dev: t.detach().to(dev, copy=True) for dev in mesh.local_devices})

    return walk(tree, param_shardings(tree))


def whole(leaf: Any, device: Optional[torch.device] = None) -> torch.Tensor:
    """One placed leaf whole on ``device`` (its first device when None):
    the first copy of a ``Replicated``, the blocks of a ``RowShards`` in
    row order. A plain tensor is moved to ``device``."""
    if isinstance(leaf, Replicated):
        t = next(iter(leaf.values()))
    elif isinstance(leaf, RowShards):
        t = leaf[0 : leaf.shape[0]]
    else:
        t = leaf
    return t if device is None else t.to(device)


def gather(tree: Any, device: Optional[torch.device] = None) -> Any:
    """A placed tree whole on ``device``: a plain pytree of tensors, the
    row-sharded leaves assembled (``whole``)."""
    if tree is None:
        return None
    if is_placed(tree) or torch.is_tensor(tree):
        return whole(tree, device)
    if isinstance(tree, dict):
        return {k: gather(v, device) for k, v in tree.items()}
    return type(tree)(gather(v, device) for v in tree)


def batch_rows(mesh: Mesh, rows: int) -> List[range]:
    """The global rows of each data replica d (grid row d) of a batch of
    ``rows``: equal contiguous blocks in grid order, as ``P('data')``
    splits them. Raises where 'data' does not divide the batch."""
    data = mesh.shape["data"]
    if rows % data:
        raise ValueError(f"a batch of {rows} rows does not split over data={data}")
    b = rows // data
    return [range(d * b, (d + 1) * b) for d in range(data)]


__all__ = ["AXES", "Mesh", "Replicated", "RowShards", "batch_rows", "gather", "is_placed",
           "make_mesh", "param_shardings", "place", "replicate", "whole"]
