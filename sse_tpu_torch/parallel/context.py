"""Context (sequence) parallelism for the transformer tower (port of
``sse_tpu/parallel/context.py``).

The recurrent towers have nothing to split along the sequence (the
recurrence is serial in L); the transformer is where a long document
could outgrow one card, so its encode can split the sequence over
shards:

* tokens are split [B, L/n] over the shards of a single-axis
  ``{'seq': n}`` grid (``cp_mesh``);
* the embeddings, the QKV and MLP products and the layer norms run on
  each shard's chunk with no communication;
* each attention layer gathers K and V (and, once, the key-side mask) in
  global order, so each shard's queries attend to every key
  (``models.towers._transformer_encode(..., cp=...)``);
* the mean readout sums each shard's partial sums and counts.

Within one process the gather is a ``torch.cat`` of the shards' K and V,
moved to each shard's device; across processes it is
``distributed.gather_rows(..., scatter=True)``, whose backward sums the
cotangents over the ranks. The results equal the unsharded encode up to
the order of the readout's sums.

Axis contract, as in the JAX package: CP runs on its own single-axis
``{'seq': n}`` grid, never on the 'model' axis of an index.
``index.build_index(cp_shards=n)`` encodes on such a grid and then places
the rows onto the 'model'-sharded index, so the two placements compose.
Only the ``mean`` readout splits this way (a sum over shards); RNN and
bag-of-subwords towers refuse CP with the JAX package's messages.

Gradients: the tower params are replicated over 'seq', so their
gradients are the sums over the shards. In one process each shard's copy
is a differentiable ``.to`` of the caller's params, so autograd sums them;
across processes every param a shard uses on its own chunk passes
through ``distributed.sum_grads_over_ranks`` (the projection after the
pooled sum, which every rank computes whole, does not). Without that sum
a gradient would be one shard's part.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from sse_tpu_torch.models import towers
from sse_tpu_torch.models.towers import PROJECTION, Params, SeqShards, TowerConfig
from sse_tpu_torch.parallel import distributed
from sse_tpu_torch.parallel.mesh import AXES, Mesh, _normalized, _visible_cards

@dataclasses.dataclass(frozen=True, eq=False)
class SeqMesh:
    """A single-axis ``{'seq': n}`` grid: ``devices[i]`` holds shard i,
    ``ranks[i]`` is the process that owns it, ``rank`` this process. A
    device may hold several shards (they then run in turn)."""

    devices: Sequence[torch.device]
    ranks: Sequence[int]
    rank: int = 0

    @property
    def shape(self):
        return {"seq": len(self.devices)}

    @property
    def local(self) -> List[int]:
        """This process's shards, in order."""
        return [i for i, r in enumerate(self.ranks) if r == self.rank]

    @property
    def multi_process(self) -> bool:
        return len(set(self.ranks)) > 1


def cp_mesh(n: int, devices: Optional[Sequence] = None) -> SeqMesh:
    """A dedicated ``{'seq': n}`` grid of the first ``n`` devices (raises
    with fewer). ``devices``: this process's, every visible card when None
    (raises where there is none). In a process group of several ranks the
    grid holds every rank's devices in rank order, as ``make_mesh``'s."""
    if devices is None:
        local = [distributed.local_device()] if distributed.world_size() > 1 else _visible_cards()
    else:
        local = list(devices)
    local = [_normalized(d) for d in local]
    if distributed.world_size() > 1:
        per_rank = distributed.all_gather_object([str(d) for d in local])
        flat = [(torch.device(d), r) for r, names in enumerate(per_rank) for d in names]
    else:
        flat = [(d, 0) for d in local]
    if len(flat) < n:
        raise ValueError(f"need {n} devices for CP, have {len(flat)}")
    flat = flat[:n]
    return SeqMesh([d for d, _ in flat], [r for _, r in flat], distributed.rank())


def _seq_axis(mesh, axis: str) -> SeqMesh:
    """``mesh``'s shards along ``axis``: a ``SeqMesh`` as it is, or the
    first line of a ('data', 'model') grid along one of its axes."""
    if isinstance(mesh, SeqMesh):
        if axis != "seq":
            raise KeyError(axis)
        return mesh
    if not isinstance(mesh, Mesh) or axis not in AXES:
        raise KeyError(axis)
    line = (lambda a: a[:, 0]) if axis == "data" else (lambda a: a[0, :])
    return SeqMesh(list(line(mesh.devices)), [int(r) for r in line(mesh.ranks)], mesh.rank)


def check_cp_config(cfg: TowerConfig) -> None:
    """Raise unless the tower supports context parallelism."""
    if cfg.cell != "transformer":
        raise ValueError(
            f"context parallelism shards attention; cell={cfg.cell!r} "
            "has no sharding dimension in L (RNNs are sequential, bow "
            "pools locally)"
        )
    if cfg.readout not in ("mean",):
        raise ValueError(
            "context-parallel readout supports 'mean' (psum-poolable); "
            f"got {cfg.readout!r}"
        )


def _gather_fn(seq: SeqMesh):
    """``SeqShards.gather`` for this process's shards of ``seq``."""
    local = seq.local
    devs = [seq.devices[i] for i in local]

    def gather(parts: List[torch.Tensor], dim: int) -> List[torch.Tensor]:
        lead = devs[0]
        whole = torch.cat([p.to(lead) for p in parts], dim=dim)
        if seq.multi_process:
            whole = distributed.gather_rows(whole, dim, scatter=True)
        on = {lead: whole}
        for dev in devs:
            if dev not in on:
                on[dev] = whole.to(dev)
        return [on[dev] for dev in devs]

    return gather


def make_cp_encoder(cfg: TowerConfig, mesh, axis: str = "seq"):
    """Build once, call many times: ``fn(params, tokens, lengths) ->
    [B, encoding_dim]`` L2-normalized embeddings (on the device of this
    process's first shard), with the sequence split over
    ``mesh.shape[axis]`` shards. The token width must be a multiple of the
    shard count (pad with 0s past ``lengths``). Differentiable in
    ``params``."""
    check_cp_config(cfg)
    seq = _seq_axis(mesh, axis)
    n = seq.shape["seq"]
    local = seq.local
    if not local:
        raise ValueError("this process holds no shard of the 'seq' grid")

    def fn(params: Params, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        b, width = tokens.shape
        if width % n:
            raise ValueError(f"sequence length {width} not divisible by {n} shards")
        lc = width // n
        shared = params
        if seq.multi_process:
            shared = {k: v if k in PROJECTION else _sum_grads(v) for k, v in params.items()}
        ps, embs, valids, offsets = [], [], [], []
        for i in local:
            dev = seq.devices[i]
            p = _to(shared, dev)
            tok = tokens[:, i * lc : (i + 1) * lc].to(dev).long()
            pos = i * lc + torch.arange(lc, device=dev)
            ps.append(p)
            embs.append(towers._embed(p["embed"], tok, cfg.embed_grad))
            valids.append((pos[None, :] < lengths.to(dev)[:, None]).float())
            offsets.append(i * lc)
        states = towers._transformer_encode(
            ps, cfg, embs, valids, cp=SeqShards(offsets, width, _gather_fn(seq)))
        out_dev = seq.devices[local[0]]
        s = sum((st * v[:, :, None]).sum(1).to(out_dev) for st, v in zip(states, valids))
        c = sum(v.sum(1, keepdim=True).to(out_dev) for v in valids)
        if seq.multi_process:  # every rank computes the same readout from here
            s = distributed.gather_rows(s[None]).sum(0)
            c = distributed.gather_rows(c[None]).sum(0)
        feats = s / torch.clamp(c, min=1.0)
        return towers.project({k: params[k].to(out_dev) for k in PROJECTION}, feats)

    return fn


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev)


def _sum_grads(tree):
    if isinstance(tree, dict):
        return {k: _sum_grads(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sum_grads(v) for v in tree)
    return distributed.sum_grads_over_ranks(tree)


def encode_context_parallel(
    params: Params,
    cfg: TowerConfig,
    tokens: torch.Tensor,  # [B, L] int, L % mesh.shape[axis] == 0
    lengths: torch.Tensor,  # [B] int
    mesh,
    axis: str = "seq",
) -> torch.Tensor:
    """L2-normalized [B, encoding_dim] embeddings with the sequence split
    over ``mesh``'s ``axis`` (a one-shot ``make_cp_encoder``; loops build
    the encoder once)."""
    check_cp_config(cfg)  # the guard rails fire before the axis lookup
    n = _seq_axis(mesh, axis).shape["seq"]
    if tokens.shape[1] % n:
        raise ValueError(f"sequence length {tokens.shape[1]} not divisible by {n} shards")
    return make_cp_encoder(cfg, mesh, axis)(params, tokens, lengths)


def local_cp_mesh(n: int, device) -> SeqMesh:
    """A ``{'seq': n}`` grid of this process's devices beside ``device``:
    the visible cards in turn (shard i on card i mod their count) for a
    card, ``device`` n times otherwise."""
    device = _normalized(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i % count) for i in range(n)]
    else:
        devices = [device] * n
    return SeqMesh(devices, [distributed.rank()] * n, distributed.rank())


__all__ = ["SeqMesh", "check_cp_config", "cp_mesh", "encode_context_parallel",
           "local_cp_mesh", "make_cp_encoder"]
