"""The train step on a ('data', 'model') grid (port of what the JAX train
step does over ``param_shardings`` / ``batch_sharding`` inputs,
``sse_tpu/train/loop.py:227-283``: one global loss, its gradient reduced
over the grid).

Placement (``place_state``, ``parallel.mesh.place``): the tower params,
their Adam moments and EMA copies are ``Replicated`` on each device; the
``target_table`` (source-encoder-only mode) is a ``RowShards`` over
'model', each block replicated over 'data'.

A step computes the one-device step's loss over the global batch:

* the batch is split over 'data' in grid order; each data replica
  encodes its own rows up to the readout's features
  (``towers.encode_features``) on the device of its grid row's first
  entry, and its contiguous share of the global candidate rows (labels,
  mined hard negatives, uniform negatives). The merged scan's gate
  counts the global batch, as the JAX step's does;
* each replica draws the one-device step's dropout masks for the global
  rows and keeps its own (``towers.RowDraw``; the merged scan's one mask
  over ``[src; candidates]`` is taken at both offsets); the uniform
  negatives come from a generator on the replica's device seeded from the
  step, so every replica draws the same rows; the hard-negative cache is
  whole and identical on every device, and each replica mines its rows;
* the features are gathered in global order (autograd sees the gather)
  and projected as the one-device step projects them, in one product a
  tower pass, so the projection's weight gradient is rounded to bf16
  once, over the global batch, as on one device (a projection on each
  replica would round each replica's part: 2^-9 apart, which Adam
  amplifies where a gradient nearly cancels). The loss is the one-device
  loss on the global embeddings: the global denominator, in-batch
  candidates, false-negative masks and the bidirectional square. With
  ``kind="full"`` each (replica, block) entry scores its replica's rows
  against its table block (``losses.block_softmax``), a row's
  log-sum-exp is combined over the blocks, and the per-row terms are
  gathered; no device holds a [B, T] logits matrix;
* every other parameter is read before a gather, so each replica's
  backward gives its part of its gradient; the parts are summed over
  'data' (each column's own table block included; across processes with
  ``distributed.sum_over_ranks``, in rank order, the same on every rank)
  and copied to every copy. Weights that a bf16 product reads inside the
  tower (the transformer's, the attention readout's) keep a rounding a
  replica, as in JAX's SPMD step;
* the global norm counts each element once (one copy of each replicated
  leaf, each table block once) and equals the one-device step's; clip,
  Adam, ``p - lr·u`` and the bias-corrected EMA run on every copy from
  identical inputs, so the copies stay identical.

Across processes (``parallel.distributed``) every rank holds whole grid
rows, in rank order (the grid's rows are the ranks' rows of the global
batch, as ``host_local_array_to_global_array(..., P('data'))``
assembles them); each rank repeats the projection and the global loss
on the gathered features, and ``distributed.gather_rows``'s backward
takes the rank's slice of the cotangent. So a candidate loss gives every
rank the projection's whole gradient (not summed over the ranks). The
full softmax scores each rank's own rows, so the cotangent of the
projected rows is summed over the ranks before the projection's backward
(``distributed.sum_grads_over_ranks``): every rank then has the whole
cotangent and the projection's whole gradient, rounded once, as on one
device.

The step is the one-device step's profiler ranges plus
``sse.train.grad_sum`` (the sum over 'data') and, with a sharded table,
``sse.train.combine`` (the cross-block log-softmax combine).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from sse_tpu_torch.models import towers
from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
from sse_tpu_torch.models.towers import PROJECTION, RowDraw
from sse_tpu_torch.parallel import distributed
from sse_tpu_torch.parallel.mesh import (
    Mesh,
    Replicated,
    RowShards,
    batch_rows,
    gather,
    is_placed,
    place,
)
from sse_tpu_torch.train import losses as losses_lib
from sse_tpu_torch.train.loop import (
    ScaleByAdamState,
    TrainConfig,
    TrainState,
    _dropout_seed,
    _step_seed,
    adam_count,
    clip_to,
    ema_update,
    make_negatives,
    make_optimizer,
    scale_by_adam_update,
    step_plan,
)


# ------------------------------------------------------------- placement
def place_state(state: TrainState, mesh: Mesh) -> TrainState:
    """``state`` on ``mesh`` (the counterpart of ``jax.device_put(state,
    param_shardings(mesh, state))``): params, Adam moments and EMA placed
    by ``parallel.mesh.place``, ``lr`` on this process's first device. A
    state already on ``mesh`` is returned as it is."""
    if state.mesh is mesh:
        return state
    if state.mesh is not None:
        raise ValueError("the state lives on another grid: gather it first")
    opt = state.opt_state
    if opt is not None:
        opt = ScaleByAdamState(count=adam_count(opt.count, mesh.local_devices[0]),
                               mu=place(opt.mu, mesh), nu=place(opt.nu, mesh))
    return TrainState(
        params=place(state.params, mesh), opt_state=opt, step=state.step,
        lr=state.lr.detach().to(mesh.local_devices[0], copy=True),
        ema_params=place(state.ema_params, mesh), mesh=mesh,
    )


def gather_state(state: TrainState, device: Optional[torch.device] = None) -> TrainState:
    """A state on a grid whole on ``device`` (this process's first device
    when None): the one-device state it stands for, the table assembled."""
    if state.mesh is None:
        return state
    device = device or state.mesh.local_devices[0]
    opt = state.opt_state
    if opt is not None:
        opt = ScaleByAdamState(count=adam_count(opt.count, device), mu=gather(opt.mu, device),
                               nu=gather(opt.nu, device))
    return TrainState(params=gather(state.params, device), opt_state=opt, step=state.step,
                      lr=state.lr.to(device), ema_params=gather(state.ema_params, device))


def _leaves(tree: Any, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, placed leaf) in JAX's pytree order (dict keys sorted)."""
    if is_placed(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]


def _rebuild(tree: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(t):
        if is_placed(t):
            return next(it)
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return type(t)(build(v) for v in t)

    return build(tree)


class _Copies:
    """Every copy of every leaf of a placed tree, flat: ``tensors[i]`` on
    ``devices[i]``, a copy of part ``groups[i]`` (a leaf, or one block of a
    row-sharded leaf). Trees of one placement flatten alike."""

    def __init__(self, tree: Any):
        self.tree = tree
        self.tensors: List[torch.Tensor] = []
        self.devices: List[torch.device] = []
        self.groups: List[Tuple[int, int]] = []
        self.paths = [path for path, _ in _leaves(tree)]
        for li, (_, leaf) in enumerate(_leaves(tree)):
            if isinstance(leaf, RowShards):
                items = [(s, dev, t) for s, blk in enumerate(leaf.blocks) for dev, t in blk.items()]
            else:
                items = [(0, dev, t) for dev, t in leaf.items()]
            for s, dev, t in items:
                self.tensors.append(t)
                self.devices.append(dev)
                self.groups.append((li, s))

    def rebuild(self, tensors: List[torch.Tensor]) -> Any:
        """The tree with ``tensors`` (in this flat order) as its copies."""
        it = iter(tensors)
        leaves = []
        for _, leaf in _leaves(self.tree):
            if isinstance(leaf, RowShards):
                blocks = [{dev: next(it) for dev in blk} for blk in leaf.blocks]
                leaves.append(RowShards(leaf.mesh, blocks, leaf.shape, leaf.dtype))
            else:
                leaves.append(Replicated({dev: next(it) for dev in leaf}))
        return _rebuild(self.tree, leaves)

    def parts(self) -> Dict[Tuple[int, int], List[int]]:
        """Each part's copies (flat indices), in order."""
        out: Dict[Tuple[int, int], List[int]] = {}
        for i, g in enumerate(self.groups):
            out.setdefault(g, []).append(i)
        return out


def _view(tree: Any, device: torch.device) -> Any:
    """The plain tree of ``device``'s copies (a row-sharded leaf stays a
    ``RowShards``: the step reads its blocks itself)."""
    if isinstance(tree, Replicated):
        return tree[device]
    if isinstance(tree, RowShards) or torch.is_tensor(tree):
        return tree
    if isinstance(tree, dict):
        return {k: _view(v, device) for k, v in tree.items()}
    return type(tree)(_view(v, device) for v in tree)


def _at(x: Any, device: torch.device) -> Any:
    """``x`` on ``device``: its copy there (a ``Replicated``), else moved."""
    if x is None:
        return None
    return x[device] if isinstance(x, Replicated) else x.to(device)


def _rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` padded with zero rows to ``n`` rows."""
    return F.pad(x, (0, 0) * (x.dim() - 1) + (0, n - x.shape[0])) if x.shape[0] < n else x


def _normalized(t: torch.Tensor) -> torch.Tensor:
    return t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-6)


# ------------------------------------------------------------------ step
def make_grid_step(
    model_cfg: SSEConfig,
    cfg: TrainConfig,
    mesh: Mesh,
    sample_negatives: Optional[Callable[[int, int, int], torch.Tensor]] = None,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step_fn(state, src, src_len, labels, weight, tgt_tokens, tgt_lens
    [, tgt_emb_cache, labels_multi])`` on ``mesh``, the one-device step's
    signature: the batch operands are this process's rows of the global
    batch of ``cfg.batch_size`` (all of it in one process);
    ``tgt_tokens``, ``tgt_lens`` and ``tgt_emb_cache`` are tensors or
    ``Replicated`` copies on this process's devices. Raises where a
    process holds part of a grid row, or where 'data' does not divide the
    batch."""
    data, model = mesh.shape["data"], mesh.shape["model"]
    reps = [d for d in range(data) if mesh.is_local(d, 0)]
    for d in range(data):
        held = [mesh.is_local(d, s) for s in range(model)]
        if any(held) and not all(held):
            raise ValueError("a process must hold whole rows of the training grid")
    if not reps or reps != list(range(reps[0], reps[0] + len(reps))):
        raise ValueError("this process's rows of the training grid must be contiguous")
    multi = mesh.multi_process
    if multi and len(reps) * distributed.world_size() != data:
        raise ValueError("every process must hold as many rows of the training grid")
    b = len(batch_rows(mesh, cfg.batch_size)[0])
    B = cfg.batch_size
    dev = {d: mesh.devices[d, 0] for d in reps}
    lead = dev[reps[0]]
    tx = make_optimizer(cfg)
    loss_cfg = cfg.loss
    use_dropout, merged_scan = step_plan(model_cfg, cfg)
    negatives = make_negatives(cfg, sample_negatives)
    seo = model_cfg.mode == NetworkMode.SOURCE_ENCODER_ONLY
    # the projections read the gathered features, and every rank computes
    # their gradients whole (with the full softmax, from the cotangent
    # summed over the ranks)
    whole = PROJECTION

    def cat_global(parts: List[torch.Tensor], rows: Optional[int] = None) -> torch.Tensor:
        """The local replicas' parts (each padded to ``rows``) in global
        order on ``lead``: across processes every rank's, by gather_rows."""
        if rows is not None:
            parts = [_rows(p, rows) for p in parts]
        x = torch.cat([p.to(lead) for p in parts])
        return distributed.gather_rows(x) if multi else x

    def table_rows(table: RowShards, rows: torch.Tensor, d: int) -> torch.Tensor:
        """Normalized table rows ``rows`` on replica d's device, read from
        the block copies of grid row d."""
        t = table.rows_per_shard
        out = None
        for s in range(model):
            at = mesh.devices[d, s]
            local = rows.to(at) - s * t
            here = ((local >= 0) & (local < t)).float()[:, None]
            part = (table.blocks[s][at][local.clamp(0, t - 1)] * here).to(dev[d])
            out = part if out is None else out + part
        return _normalized(out)

    def full_terms(table: RowShards, src_emb, labels, weight, lm, d):
        """Replica d's per-row weighted log-probabilities of the label and
        accuracy hits, over every block of the table."""
        t = table.rows_per_shard
        parts = []
        for s in range(model):
            at = mesh.devices[d, s]
            tbl = _normalized(table.blocks[s][at])
            part = losses_lib.block_softmax(
                src_emb.to(at), tbl, labels.to(at), s * t, loss_cfg.scale, loss_cfg.margin,
                None if lm is None else lm.to(at))
            parts.append([x.to(dev[d]) for x in part])
        with record_function("sse.train.combine"):
            logp, arg = losses_lib.combine_blocks(parts)
        return logp * weight, (arg == labels).float() * weight

    src_side = ("src_tower", model_cfg.src_tower)
    tgt_side = ("tgt_tower", model_cfg.tgt_tower) if model_cfg.mode == NetworkMode.DUAL_ENCODER \
        else src_side

    def features(views, side, d, tokens, lengths, dropout):
        name, tower = side
        return towers.encode_features(views[dev[d]][name], tower, tokens, lengths, dropout)

    def project(views, side, feats):
        return towers.project(views[lead][side[0]], feats)

    def loss_fn(views, table, inputs, tgt_tokens, tgt_lens, cache, step):
        gens = {}
        if use_dropout:
            for d in reps:
                gens[d] = torch.Generator(device=dev[d]).manual_seed(
                    _step_seed(_dropout_seed(cfg.seed), step))
        labels_g = cat_global([x[2] for x in inputs.values()])
        weight_g = cat_global([x[3] for x in inputs.values()])
        lm_g = None
        if inputs[reps[0]][4] is not None:
            lm_g = cat_global([x[4] for x in inputs.values()])
        num_targets = _target_rows(tgt_tokens)

        def cand_split(c):
            per = -(-c // data)
            return per, {d: (min(d * per, c), min((d + 1) * per, c)) for d in reps}

        def cand_rows_at(d, hard_g):
            parts = [labels_g.to(dev[d])]
            if hard_g is not None:
                parts.append(hard_g.to(dev[d]))
            if loss_cfg.kind == "sampled":
                parts.append(negatives(step, num_targets, dev[d]))
            return torch.cat(parts)

        def drop(d, rows, segments):
            return RowDraw(gens[d], rows, segments) if use_dropout else None

        src_feats, cand_feats = [], []
        if merged_scan:  # one tower pass a replica, one projection of all rows
            c = B + (loss_cfg.num_negatives if loss_cfg.kind == "sampled" else 0)
            per, share = cand_split(c)
            for d, (src, src_len, *_rest) in inputs.items():
                rows = cand_rows_at(d, None)
                lo, hi = share[d]
                ct, cl = _at(tgt_tokens, dev[d])[rows[lo:hi]], _at(tgt_lens, dev[d])[rows[lo:hi]]
                width = max(src.shape[1], ct.shape[1])
                pad = lambda x: F.pad(x, (0, width - x.shape[1]))  # noqa: E731
                f = features(views, src_side, d, torch.cat([pad(src), pad(ct)]),
                             torch.cat([src_len, cl]),
                             drop(d, B + c, ((d * b, b), (B + lo, hi - lo))))
                src_feats.append(f[:b])
                cand_feats.append(f[b:])
            emb = project(views, src_side, torch.cat([cat_global(src_feats),
                                                      cat_global(cand_feats, per)[:c]]))
            return losses_lib.similarity_loss(
                loss_cfg, emb[:B], labels_g, weight_g, cand_emb=emb[B:],
                cand_rows=cand_rows_at(reps[0], None), labels_multi=lm_g)

        for d, (src, src_len, *_rest) in inputs.items():
            src_feats.append(features(views, src_side, d, src, src_len, drop(d, B, ((d * b, b),))))
        src_emb = project(views, src_side, cat_global(src_feats))
        if loss_cfg.kind == "full":
            if multi:  # each rank's terms give the cotangent of its own rows
                src_emb = distributed.sum_grads_over_ranks(src_emb)
            terms, hits = [], []
            for d, (_s, _l, labels, weight, lm) in inputs.items():
                term, hit = full_terms(table, src_emb[d * b : (d + 1) * b], labels, weight, lm, d)
                terms.append(term)
                hits.append(hit)
            denom = torch.clamp(weight_g.sum(), min=1.0)
            with record_function("sse.train.loss"):
                loss = -cat_global(terms).sum() / denom
                acc = cat_global(hits).sum() / denom
            return loss, acc.detach()
        hard_g = None
        if loss_cfg.num_hard_negatives > 0 and cache is not None:
            with record_function("sse.train.mine"):
                hard_g = cat_global([
                    losses_lib.mine_hard_negative_rows(
                        src_emb[d * b : (d + 1) * b].to(dev[d]), _at(cache, dev[d]), x[2],
                        loss_cfg.num_hard_negatives, labels_multi=x[4])
                    for d, x in inputs.items()])
        c = B + (0 if hard_g is None else hard_g.shape[0]) + (
            loss_cfg.num_negatives if loss_cfg.kind == "sampled" else 0)
        per, share = cand_split(c)
        cand_rows = cand_rows_at(reps[0], hard_g)
        if seo:
            cand_emb = cat_global([table_rows(table, cand_rows_at(d, hard_g)[slice(*share[d])], d)
                                   for d in reps], per)[:c]
        else:
            for d in reps:
                rows = cand_rows_at(d, hard_g)
                lo, hi = share[d]
                if hi > lo:
                    cand_feats.append(features(
                        views, tgt_side, d, _at(tgt_tokens, dev[d])[rows[lo:hi]],
                        _at(tgt_lens, dev[d])[rows[lo:hi]], drop(d, c, ((lo, hi - lo),))))
                else:
                    cand_feats.append(torch.zeros((0, tgt_side[1].hidden), device=dev[d]))
            cand_emb = project(views, tgt_side, cat_global(cand_feats, per)[:c])
        return losses_lib.similarity_loss(
            loss_cfg, src_emb, labels_g, weight_g, cand_emb=cand_emb, cand_rows=cand_rows,
            labels_multi=lm_g)

    def step_fn(state, src, src_len, labels, weight, tgt_tokens, tgt_lens,
                tgt_emb_cache=None, labels_multi=None):
        if state.mesh is not mesh:
            raise ValueError("the state is not on this step's grid (train.grid.place_state)")
        if src.shape[0] != len(reps) * b:
            raise ValueError(f"this process feeds {len(reps) * b} rows of the global batch "
                             f"of {B}, got {src.shape[0]}")
        flat = _Copies(state.params)
        req = [t.detach().requires_grad_(True) for t in flat.tensors]
        params = flat.rebuild(req)
        views = {dev[d]: _view(params, dev[d]) for d in reps}
        table = params.get("target_table")
        inputs = {}
        for i, d in enumerate(reps):
            sl = slice(i * b, (i + 1) * b)
            inputs[d] = (
                src[sl].to(dev[d]), src_len[sl].to(dev[d]), labels[sl].to(dev[d]).long(),
                weight[sl].to(dev[d]),
                None if labels_multi is None else labels_multi[sl].to(dev[d]).long(),
            )
        with record_function("sse.train.forward"):
            loss, acc = loss_fn(views, table, inputs, tgt_tokens, tgt_lens, tgt_emb_cache,
                                state.step)
        with record_function("sse.train.backward"):
            grads = torch.autograd.grad(loss, req, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(req, grads)]
        with torch.no_grad():
            with record_function("sse.train.grad_sum"):
                grads, totals = _sum_over_data(flat, grads, multi, whole)
            with record_function("sse.train.update"):
                new_state, gnorm = _update(state, flat, grads, totals, tx, cfg, lead)
        metrics = {"loss": loss.detach(), "accuracy": acc, "grad_norm": gnorm}
        return new_state, metrics

    return step_fn


def _target_rows(tgt_tokens: Any) -> int:
    """The target space's row count (the range of the uniform negatives)."""
    return next(iter(tgt_tokens.values())).shape[0] if isinstance(tgt_tokens, Replicated) \
        else tgt_tokens.shape[0]


def _sum_over_data(flat: _Copies, grads: List[torch.Tensor], multi: bool, whole=()):
    """Each part's gradient summed over its copies (the replicas on each
    device) and, across processes, over the ranks, except the leaves named
    in ``whole``, whose gradient every rank computed whole; copied back to
    every copy. Returns (the copies' gradients, each part's total)."""
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    totals = {}
    for part, idxs in flat.parts().items():
        home = flat.devices[idxs[0]]
        total = grads[idxs[0]]
        for i in idxs[1:]:
            total = total + grads[i].to(home)
        if multi and flat.paths[part[0]][-1] not in whole:
            total = distributed.sum_over_ranks(total)
        totals[part] = total
        for i in idxs:
            out[i] = total if flat.devices[i] == home else total.to(flat.devices[i])
    return out, totals


def _norm(flat: _Copies, totals: Dict[Tuple[int, int], torch.Tensor], lead) -> torch.Tensor:
    """The global norm of a placed tree given each part's tensor: every
    element once (one copy of a replicated leaf, each block once)."""
    sq = [torch.sum(t * t).to(lead) for t in totals.values()]
    return torch.sqrt(sum(sq))


def _update(state: TrainState, flat: _Copies, grads, totals, tx, cfg: TrainConfig, lead):
    g_norm = _norm(flat, totals, lead)
    at = {d: (g_norm.to(d), state.lr.to(d)) for d in set(flat.devices)}
    clipped = [clip_to(g, at[d][0], cfg.max_gradient_norm) for g, d in zip(grads, flat.devices)]
    opt = state.opt_state
    if opt is None:
        updates, new_opt = clipped, None
    else:
        mu, nu = _Copies(opt.mu), _Copies(opt.nu)
        updates, adam = scale_by_adam_update(
            clipped, ScaleByAdamState(count=opt.count, mu=mu.tensors, nu=nu.tensors))
        new_opt = ScaleByAdamState(count=adam.count, mu=mu.rebuild(adam.mu),
                                   nu=nu.rebuild(adam.nu))
    if cfg.norm_metric == "update":
        parts = {}
        for g, u in zip(flat.groups, updates):
            parts.setdefault(g, u)
        gnorm = _norm(flat, parts, lead)
    elif cfg.norm_metric == "grad":
        gnorm = g_norm
    else:
        gnorm = torch.zeros((), dtype=torch.float32, device=lead)
    new = [p - at[d][1] * u for p, u, d in zip(flat.tensors, updates, flat.devices)]
    ema = state.ema_params
    if ema is not None:
        ema_flat = _Copies(ema)
        step_t = torch.full((), state.step, dtype=torch.int32, device=lead)
        ema = ema_flat.rebuild(ema_update(cfg.ema_decay, ema_flat.tensors, new, step_t))
    new_state = TrainState(params=flat.rebuild(new), opt_state=new_opt, step=state.step + 1,
                           lr=state.lr, ema_params=ema, mesh=state.mesh)
    return new_state, gnorm


def copies_identical(state: TrainState) -> bool:
    """Whether every copy of every part of the state (params, Adam
    moments, EMA) equals the part's first copy bit for bit."""
    trees = [state.params, state.ema_params]
    if state.opt_state is not None:
        trees += [state.opt_state.mu, state.opt_state.nu]
    for tree in trees:
        if tree is None:
            continue
        flat = _Copies(tree)
        for idxs in flat.parts().values():
            first = flat.tensors[idxs[0]]
            for i in idxs[1:]:
                if not torch.equal(flat.tensors[i].to(first.device), first):
                    return False
    return True


__all__ = ["copies_identical", "gather_state", "make_grid_step", "place_state"]
