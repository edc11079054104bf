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

The step is written as per-card calls (``rt.call(card, fn, *args)``)
with the values that cross cards moved between them, so that it runs
two ways with the same sums: plain (``_Plain``: one autograd graph over
every card, the moves ``Tensor.to``, one ``autograd.grad``; a grid whose
entries lie on one card, and a grid across processes) or segmented
(``_Segments``, the default on a single-process grid of several cards):
each call's autograd graph lies on its card, a differentiable value
enters a call as a leaf of its own, and the backward walks the calls in
reverse, each call's backward on its card, the cotangents copied back
between them. Either way a ``utils.graphs.Recorder`` can take each
card's work as CUDA graphs in that card's pool and the copies between
cards as the work issued between the replays: the chain of
``loop.make_train_step(mesh=, chain=K)`` (``loop._GridChain``). The step
reads no device value on the host: its step number for the EMA and its
generators come from ``draws`` (a chain's, seeded before each replay) or
are made from ``state.step``.

Across processes the step runs ``_Plain`` on the rank's card. Its
collectives are ``distributed.gather_rows`` (the global operands, the
features, the candidates and the per-row terms; an ``all_gather`` each,
no collective in the backward), the ``all_reduce`` of
``sum_grads_over_ranks``'s backward (the full softmax) and one
``all_reduce`` a leaf of the sum over 'data' (``_sum_over_data``); none
reads a value on the host, and their shapes and order follow from the
config and the batch shape alone, so every rank issues the same
sequence. Over NCCL (``distributed.captures()``) a ``Recorder`` takes
the whole step, its collectives included, into the rank's graph; over
gloo, whose collectives run on the host, the step stays eager.

The step is the one-device step's profiler ranges plus
``sse.train.grad_sum`` (the sum over 'data') and, with a sharded table,
``sse.train.combine`` (the cross-block log-softmax combine).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

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
    _bias_correction,
    _Draws,
    _dropout_seed,
    _step_seed,
    adam_count,
    adam_direction,
    clip_to,
    ema_update,
    make_negatives,
    step_plan,
)
from sse_tpu_torch.utils import graphs
from sse_tpu_torch.utils.profiling import span


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
    return _build(tree, iter(leaves))


def _build(t: Any, it) -> Any:
    """``t``'s structure over the placed leaves ``it`` yields (no closure:
    a recursive one is a reference cycle that keeps the leaves alive until
    the cyclic collector runs, which is off while a chain records)."""
    if is_placed(t):
        return next(it)
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    return type(t)(_build(v, it) for v in t)


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


# ------------------------------------------------------------- runtimes
def _tensors(out: Any) -> List[torch.Tensor]:
    """The tensors of a call's result (a tensor, or nested tuples/lists)."""
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in _tensors(x)]
    return []


class _Plain:
    """The step's work as one autograd graph over every card (the plain
    version, and the step of a grid whose entries lie on one card or span
    processes): a call runs as it comes, a value moves by ``Tensor.to``
    (autograd sees the move), and one ``autograd.grad`` from the loss
    gives every copy's gradient. ``rec`` (``utils.graphs.EAGER``, or a
    ``Recorder`` on a grid of one card) receives each card's work."""

    def __init__(self, rec=graphs.EAGER) -> None:
        self.rec = rec

    @staticmethod
    def at(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
        return x

    @staticmethod
    def to(x: Optional[torch.Tensor], dev: torch.device) -> Optional[torch.Tensor]:
        return None if x is None else x.to(dev)

    def call(self, dev: torch.device, fn: Callable, *args, gens=()):
        args = [self.to(a, dev) if torch.is_tensor(a) else a for a in args]
        with self.rec.on(dev, gens):
            return fn(*args)

    def grads(self, loss, req, devices, lead) -> List[torch.Tensor]:
        with self.rec.on(lead):
            grads = torch.autograd.grad(loss, req, allow_unused=True)
            return [torch.zeros_like(p) if g is None else g for p, g in zip(req, grads)]


class _Call:
    """One call of a segmented step: its card, the differentiable values it
    took ((the call that made one, its output's index, the leaf it entered
    as)) and its outputs."""

    __slots__ = ("dev", "edges", "outs")

    def __init__(self, dev, edges, outs) -> None:
        self.dev, self.edges, self.outs = dev, edges, outs


class _Segments:
    """The step cut at every call, so that each call's autograd graph lies
    on its card: a differentiable value a call takes (another call's
    output; copied where it crosses cards) enters it as a leaf of its own,
    and any other value moves by a copy where it crosses cards. ``grads``
    walks the calls backwards: a call's backward (``autograd.grad`` from
    its outputs, each output's cotangent the sum of what its readers gave
    back, in the order they gave it) gives the cotangents of the values it
    took, each copied back to the card that made it, and its card's part
    of each parameter's gradient; a parameter's parts are summed in the
    same order. With a ``Recorder`` a card's forward and backward work
    land in its graphs, and the copies are kept for the replays. ``where``
    knows the card of every value the step made (the CPU tests label
    devices; a CPU tensor drops the label)."""

    def __init__(self, rec=graphs.EAGER) -> None:
        self.rec = rec
        self.where: Dict[int, Tuple[torch.Tensor, torch.device]] = {}
        self.calls: List[_Call] = []
        self.made: Dict[int, Tuple[_Call, int]] = {}

    def at(self, x: torch.Tensor, dev: torch.device) -> torch.Tensor:
        self.where[id(x)] = (x, dev)
        return x

    def device_of(self, x: torch.Tensor) -> torch.device:
        hit = self.where.get(id(x))
        return hit[1] if hit is not None and hit[0] is x else x.device

    def _move(self, x: torch.Tensor, src: torch.device, dev: torch.device) -> torch.Tensor:
        return x if src == dev else self.at(self.rec.copy(x, dev), dev)

    def to(self, x: Optional[torch.Tensor], dev: torch.device) -> Optional[torch.Tensor]:
        if x is None:
            return None
        if x.requires_grad:
            raise RuntimeError("a differentiable value moves between cards only into a call")
        return self._move(x, self.device_of(x), dev)

    def call(self, dev: torch.device, fn: Callable, *args, gens=()):
        ins, edges = [], []
        for a in args:
            if torch.is_tensor(a) and a.requires_grad:
                made = self.made.get(id(a))
                if made is None or made[0].outs[made[1]] is not a:
                    raise RuntimeError("a differentiable value enters a call only as another "
                                       "call's output")
                y = self._move(a.detach(), made[0].dev, dev).detach().requires_grad_(True)
                edges.append((made[0], made[1], self.at(y, dev)))
                ins.append(y)
            else:
                ins.append(self.to(a, dev) if torch.is_tensor(a) else a)
        with self.rec.on(dev, gens):
            out = fn(*ins)
        call = _Call(dev, edges, _tensors(out))
        for j, o in enumerate(call.outs):
            self.at(o, dev)
            if o.requires_grad:
                self.made[id(o)] = (call, j)
        self.calls.append(call)
        return out

    def grads(self, loss, req, devices, lead) -> List[torch.Tensor]:
        own: Dict[torch.device, List[int]] = {}
        for i, d in enumerate(devices):
            own.setdefault(d, []).append(i)
        cots: Dict[Tuple[int, int], List[Any]] = {}
        made = self.made[id(loss)]
        cots[id(made[0]), made[1]] = [None]  # the loss: d loss / d loss = 1
        parts: List[List[torch.Tensor]] = [[] for _ in req]
        for call in reversed(self.calls):
            roots = [(o, cots[id(call), j]) for j, o in enumerate(call.outs)
                     if (id(call), j) in cots]
            if not roots:
                continue
            mine = own.get(call.dev, [])
            ins = [y for _, _, y in call.edges] + [req[i] for i in mine]
            with self.rec.on(call.dev):
                gouts = [torch.ones_like(o) if cs[0] is None else _summed(cs) for o, cs in roots]
                gs = torch.autograd.grad([o for o, _ in roots], ins, grad_outputs=gouts,
                                         allow_unused=True)
            for (src, j, _), g in zip(call.edges, gs):
                if g is not None:
                    cots.setdefault((id(src), j), []).append(
                        self._move(self.at(g, call.dev), call.dev, src.dev))
            for i, g in zip(mine, gs[len(call.edges):]):
                if g is not None:
                    parts[i].append(g)
        out: List[Optional[torch.Tensor]] = [None] * len(req)
        for dev, idx in own.items():
            def total(idx=idx):
                return [torch.zeros_like(req[i]) if not parts[i] else _summed(parts[i])
                        for i in idx]

            for i, g in zip(idx, self.call(dev, total)):
                out[i] = g
        return out


def _summed(xs: List[torch.Tensor]) -> torch.Tensor:
    """((x0 + x1) + x2) + ...: the order autograd adds a value's
    cotangents in as its readers' backwards run, last reader first."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    return total


# ------------------------------------------------------------------ step
def make_grid_step(
    model_cfg: SSEConfig,
    cfg: TrainConfig,
    mesh: Mesh,
    sample_negatives: Optional[Callable[[int, int, int], torch.Tensor]] = None,
    segmented: bool = True,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step_fn(state, src, src_len, labels, weight, tgt_tokens, tgt_lens
    [, tgt_emb_cache, labels_multi], draws=None, rec=EAGER)`` on ``mesh``,
    the one-device step's signature: the batch operands are this
    process's rows of the global batch of ``cfg.batch_size`` (all of it in
    one process); ``tgt_tokens``, ``tgt_lens`` and ``tgt_emb_cache`` are
    tensors or ``Replicated`` copies on this process's devices. Raises
    where a process holds part of a grid row, or where 'data' does not
    divide the batch.

    ``segmented`` (a grid of several cards in one process): the step runs
    as per-card calls with the copies between them (``_Segments``), and
    equals the plain step (``segmented=False``, one autograd graph over
    every card) bit for bit where no value takes more than two
    contributions from other calls of one card; ``"always"`` cuts a grid
    of one card too (a check of the segments on one card). ``draws`` (a chained
    step's ``loop._Draws``: ``step_t`` a card → its int32 step, and a
    replica → its negatives' and dropout generators) replaces the ones
    the step makes from ``state.step``; ``rec`` receives each card's work
    (``utils.graphs.Recorder``)."""
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
    cards = mesh.local_devices
    cut = segmented == "always" or (segmented and not multi and len(cards) > 1)
    loss_cfg = cfg.loss
    sampled = loss_cfg.kind == "sampled"
    use_dropout, merged_scan = step_plan(model_cfg, cfg)
    negatives = make_negatives(cfg, sample_negatives)
    seo = model_cfg.mode == NetworkMode.SOURCE_ENCODER_ONLY
    # the projections read the gathered features, and every rank computes
    # their gradients whole (with the full softmax, from the cotangent
    # summed over the ranks)
    whole = PROJECTION
    src_side = ("src_tower", model_cfg.src_tower)
    tgt_side = ("tgt_tower", model_cfg.tgt_tower) if model_cfg.mode == NetworkMode.DUAL_ENCODER \
        else src_side

    def glob(x: torch.Tensor) -> torch.Tensor:
        """Across processes every rank's rows, in rank order (gather_rows)."""
        return distributed.gather_rows(x) if multi else x

    def cat(*parts):
        return glob(torch.cat(parts))

    def cand_split(c):
        per = -(-c // data)
        return per, {d: (min(d * per, c), min((d + 1) * per, c)) for d in reps}

    def eager_draws(rt, step: int) -> _Draws:
        gen = lambda d, seed: torch.Generator(device=dev[d]).manual_seed(  # noqa: E731
            _step_seed(seed, step))
        step_t = None
        if cfg.ema_decay > 0:
            step_t = {c: rt.call(c, lambda c=c: torch.full((), step, dtype=torch.int32,
                                                             device=c)) for c in cards}
        return _Draws(
            step=step, step_t=step_t,
            negatives={d: gen(d, cfg.seed) for d in reps}
            if sampled and sample_negatives is None else None,
            dropout={d: gen(d, _dropout_seed(cfg.seed)) for d in reps} if use_dropout else None)

    def loss_fn(rt, views, table, batch, tgt_tokens, tgt_lens, cache, draws):
        def features(side, d, tokens, lengths, dropout):
            name, tower = side
            return towers.encode_features(views[dev[d]][name], tower, tokens, lengths, dropout)

        src, src_len, labels, weight, labels_multi = batch
        neg_gen = lambda d: None if draws.negatives is None else draws.negatives[d]  # noqa: E731
        drop_gen = lambda d: None if draws.dropout is None else draws.dropout[d]  # noqa: E731

        def drop(d, rows, segments):
            return RowDraw(draws.dropout[d], rows, segments) if use_dropout else None

        inputs = {}
        for i, d in enumerate(reps):
            sl = slice(i * b, (i + 1) * b)
            inputs[d] = rt.call(dev[d], _batch, src[sl], src_len[sl], labels[sl], weight[sl],
                                None if labels_multi is None else labels_multi[sl])
        # this process's rows are its replicas' rows in grid order: the global
        # operands come from the batch on the first card
        labels_g, weight_g, lm_g = rt.call(lead, lambda x, w, m: (
            glob(x.long()), glob(w), None if m is None else glob(m.long())),
            labels, weight, labels_multi)
        num_targets = _target_rows(tgt_tokens)

        def cand_rows(d, hard_g):
            """Replica d's copy of the global candidate rows (labels, mined
            rows, the step's uniform negatives from its own generator)."""
            def rows(labels_g, hard_g):
                parts = [labels_g] if hard_g is None else [labels_g, hard_g]
                if sampled:
                    parts.append(negatives(draws.step, num_targets, dev[d], neg_gen(d)))
                return torch.cat(parts)

            return rt.call(dev[d], rows, labels_g, hard_g, gens=(neg_gen(d),))

        if merged_scan:  # one tower pass a replica, one projection of all rows
            c = B + (loss_cfg.num_negatives if sampled else 0)
            per, share = cand_split(c)
            rows = {d: cand_rows(d, None) for d in reps}
            src_feats, cand_feats = [], []
            for d in reps:
                lo, hi = share[d]

                def encode(src, src_len, rows, tt, tl, d=d, lo=lo, hi=hi):
                    ct, cl = tt[rows[lo:hi]], tl[rows[lo:hi]]
                    width = max(src.shape[1], ct.shape[1])
                    pad = lambda x: F.pad(x, (0, width - x.shape[1]))  # noqa: E731
                    f = features(src_side, d, torch.cat([pad(src), pad(ct)]),
                                 torch.cat([src_len, cl]),
                                 drop(d, B + c, ((d * b, b), (B + lo, hi - lo))))
                    return f[:b], f[b:]

                fs, fc = rt.call(dev[d], encode, inputs[d][0], inputs[d][1], rows[d],
                                 _at(tgt_tokens, dev[d]), _at(tgt_lens, dev[d]),
                                 gens=(drop_gen(d),))
                src_feats.append(fs)
                cand_feats.append(fc)

            def merged_loss(labels_g, weight_g, lm_g, rows0, *feats):
                n = len(reps)
                cands = glob(torch.cat([_rows(x, per) for x in feats[n:]]))[:c]
                emb = towers.project(views[lead][src_side[0]],
                                     torch.cat([cat(*feats[:n]), cands]))
                return losses_lib.similarity_loss(
                    loss_cfg, emb[:B], labels_g, weight_g, cand_emb=emb[B:], cand_rows=rows0,
                    labels_multi=lm_g)

            return rt.call(lead, merged_loss, labels_g, weight_g, lm_g, rows[reps[0]],
                           *src_feats, *cand_feats)

        src_feats = [rt.call(dev[d], lambda x, n, d=d: features(src_side, d, x, n, drop(
            d, B, ((d * b, b),))), inputs[d][0], inputs[d][1], gens=(drop_gen(d),))
            for d in reps]
        if loss_cfg.kind == "full":
            def project_src(*feats):
                emb = towers.project(views[lead][src_side[0]], cat(*feats))
                if multi:  # each rank's terms give the cotangent of its own rows
                    emb = distributed.sum_grads_over_ranks(emb)
                return tuple(emb[d * b : (d + 1) * b] for d in reps)

            slices = dict(zip(reps, _tensors(rt.call(lead, project_src, *src_feats))))
            terms, hits = [], []
            for d in reps:
                parts = []
                for s in range(model):
                    at = mesh.devices[d, s]

                    def block(x, labels, lm, s=s, at=at):
                        tbl = _normalized(table.blocks[s][at])
                        return losses_lib.block_softmax(x, tbl, labels, s * table.rows_per_shard,
                                                        loss_cfg.scale, loss_cfg.margin, lm)

                    parts.extend(rt.call(at, block, slices[d], inputs[d][2], inputs[d][4]))

                def combine(labels, weight, *ps):
                    with span("train.combine"):
                        logp, arg = losses_lib.combine_blocks(
                            [ps[i : i + 4] for i in range(0, len(ps), 4)])
                    return logp * weight, (arg == labels).float() * weight

                term, hit = rt.call(dev[d], combine, inputs[d][2], inputs[d][3], *parts)
                terms.append(term)
                hits.append(hit)

            def full_loss(weight_g, *th):
                n = len(th) // 2
                denom = torch.clamp(weight_g.sum(), min=1.0)
                with span("train.loss"):
                    loss = -cat(*th[:n]).sum() / denom
                    acc = cat(*th[n:]).sum() / denom
                return loss, acc.detach()

            return rt.call(lead, full_loss, weight_g, *terms, *hits)
        mine = loss_cfg.num_hard_negatives > 0 and cache is not None

        def project_src(*feats):
            emb = towers.project(views[lead][src_side[0]], cat(*feats))
            return emb, *[emb[d * b : (d + 1) * b].detach() for d in reps if mine]

        src_emb, *mined_of = rt.call(lead, project_src, *src_feats)
        hard_g = None
        if mine:
            with span("train.mine"):
                hard = [rt.call(dev[d], lambda e, cc, labels, lm: losses_lib.mine_hard_negative_rows(
                    e, cc, labels, loss_cfg.num_hard_negatives, labels_multi=lm),
                    e, _at(cache, dev[d]), inputs[d][2], inputs[d][4])
                    for d, e in zip(reps, mined_of)]
                hard_g = rt.call(lead, cat, *hard)
        c = B + (0 if hard_g is None else hard_g.shape[0]) + (
            loss_cfg.num_negatives if sampled else 0)
        per, share = cand_split(c)
        rows = {d: cand_rows(d, hard_g) for d in reps}
        cands = []
        for d in reps:
            lo, hi = share[d]
            if seo:
                cands.append(_table_rows(rt, mesh, table, rows[d], (lo, hi), d, dev[d]))
            elif hi > lo:
                cands.append(rt.call(dev[d], lambda r, tt, tl, d=d, lo=lo, hi=hi: features(
                    tgt_side, d, tt[r[lo:hi]], tl[r[lo:hi]], drop(d, c, ((lo, hi - lo),))),
                    rows[d], _at(tgt_tokens, dev[d]), _at(tgt_lens, dev[d]),
                    gens=(drop_gen(d),)))
            else:
                cands.append(rt.call(dev[d], lambda d=d: torch.zeros(
                    (0, tgt_side[1].hidden), device=dev[d])))

        def cand_loss(src_emb, labels_g, weight_g, lm_g, rows0, *xs):
            ce = glob(torch.cat([_rows(x, per) for x in xs]))[:c]
            if not seo:
                ce = towers.project(views[lead][tgt_side[0]], ce)
            return losses_lib.similarity_loss(
                loss_cfg, src_emb, labels_g, weight_g, cand_emb=ce, cand_rows=rows0,
                labels_multi=lm_g)

        return rt.call(lead, cand_loss, src_emb, labels_g, weight_g, lm_g, rows[reps[0]], *cands)

    def step_fn(state, src, src_len, labels, weight, tgt_tokens, tgt_lens,
                tgt_emb_cache=None, labels_multi=None, draws: Optional[_Draws] = None,
                rec=graphs.EAGER):
        if state.mesh is not mesh:
            raise ValueError("the state is not on this step's grid (train.grid.place_state)")
        if src.shape[0] != len(reps) * b:
            raise ValueError(f"this process feeds {len(reps) * b} rows of the global batch "
                             f"of {B}, got {src.shape[0]}")
        rt = _Segments(rec) if cut else _Plain(rec)
        rec.new_pass()
        flat = _Copies(state.params)
        req = [rt.at(t.detach().requires_grad_(True), d)
               for t, d in zip(flat.tensors, flat.devices)]
        params = flat.rebuild(req)
        views = {dev[d]: _view(params, dev[d]) for d in reps}
        if draws is None:  # else a captured chain's position: its generators, its step
            draws = eager_draws(rt, state.step)
        batch = (src, src_len, labels, weight, labels_multi)
        with span("train.forward"):
            loss, acc = loss_fn(rt, views, params.get("target_table"), batch, tgt_tokens,
                                tgt_lens, tgt_emb_cache, draws)
        with span("train.backward"):
            grads = rt.grads(loss, req, flat.devices, lead)
        with torch.no_grad():
            with span("train.grad_sum"):
                grads, totals = _sum_over_data(rt, flat, grads, multi, whole)
            with span("train.update"):
                new_state, gnorm = _update(rt, state, flat, grads, totals, cfg, lead, draws)
        metrics = {"loss": loss.detach(), "accuracy": acc, "grad_norm": gnorm}
        return new_state, metrics

    return step_fn


def _batch(src, src_len, labels, weight, labels_multi):
    """A replica's rows of the batch, its labels as int64."""
    return (src, src_len, labels.long(), weight,
            None if labels_multi is None else labels_multi.long())


def _table_rows(rt, mesh: Mesh, table: RowShards, rows: torch.Tensor, span, d: int,
                home: torch.device) -> torch.Tensor:
    """Normalized table rows ``rows[span]`` on replica d's card ``home``,
    read from the block copies of grid row d."""
    t = table.rows_per_shard
    parts = []
    for s in range(mesh.shape["model"]):
        at = mesh.devices[d, s]

        def part(rows, s=s, at=at):
            local = rows[slice(*span)] - s * t
            here = ((local >= 0) & (local < t)).float()[:, None]
            return table.blocks[s][at][local.clamp(0, t - 1)] * here

        parts.append(rt.call(at, part, rows))
    return rt.call(home, lambda *ps: _normalized(_summed(list(ps))), *parts)


def _target_rows(tgt_tokens: Any) -> int:
    """The target space's row count (the range of the uniform negatives)."""
    return next(iter(tgt_tokens.values())).shape[0] if isinstance(tgt_tokens, Replicated) \
        else tgt_tokens.shape[0]


def _bundled(rt, xs: Dict[int, torch.Tensor], src: Dict[int, torch.device],
             dst: Dict[int, torch.device]) -> Dict[int, torch.Tensor]:
    """``xs[i]`` (on ``src[i]``) on ``dst[i]``: what one card sends another
    goes as one flat vector a pair of cards and type, cut back into views
    there (the same values; one copy a pair, not one a tensor)."""
    groups: Dict[tuple, List[int]] = {}
    out = {}
    for i, x in xs.items():
        if src[i] == dst[i]:
            out[i] = x
        else:
            groups.setdefault((src[i], dst[i], x.dtype), []).append(i)
    for (a, b, _), idx in groups.items():
        vec = rt.to(rt.call(a, lambda *ts: torch.cat([t.reshape(-1) for t in ts]),
                            *[xs[i] for i in idx]), b)
        cut = torch.split(vec, [xs[i].numel() for i in idx])  # views: no device work
        out.update({i: rt.at(p.view(xs[i].shape), b) for i, p in zip(idx, cut)})
    return out


def _sum_over_data(rt, flat: _Copies, grads: List[torch.Tensor], multi: bool, whole=()):
    """Each part's gradient summed over its copies (the replicas on each
    device), the home copy first and the others in flat order, and, across
    processes, over the ranks, except the leaves named in ``whole``, whose
    gradient every rank computed whole; copied back to every copy. The
    other copies move to their part's home first (``_bundled``), then each
    home card sums its parts, then the totals move out. Returns (the
    copies' gradients, each part's total)."""
    parts = flat.parts()
    home = {i: flat.devices[idxs[0]] for idxs in parts.values() for i in idxs}
    on = dict(enumerate(flat.devices))
    moved = _bundled(rt, dict(enumerate(grads)), on, home)
    homes: Dict[torch.device, List[Tuple[int, int]]] = {}
    for part, idxs in parts.items():
        homes.setdefault(flat.devices[idxs[0]], []).append(part)
    totals = {}
    for card, mine in homes.items():
        def add(mine=mine):
            out = []
            for part in mine:
                idxs = parts[part]
                total = grads[idxs[0]]
                for i in idxs[1:]:
                    total = total + moved[i]
                if multi and flat.paths[part[0]][-1] not in whole:
                    total = distributed.sum_over_ranks(total)
                out.append(total)
            return out

        totals.update(zip(mine, rt.call(card, add)))
    totals = {part: totals[part] for part in parts}
    out = _bundled(rt, {i: totals[part] for part, idxs in parts.items() for i in idxs}, home, on)
    return [out[i] for i in range(len(grads))], totals


def _norm(rt, flat: _Copies, totals: Dict[Tuple[int, int], torch.Tensor], lead) -> torch.Tensor:
    """The global norm of a placed tree given each part's tensor: every
    element once (one copy of a replicated leaf, each block once), each
    part's square sum on its home card, summed in part order on ``lead``."""
    parts = flat.parts()
    homes: Dict[torch.device, List[Tuple[int, int]]] = {}
    for part in totals:
        homes.setdefault(flat.devices[parts[part][0]], []).append(part)
    sq = {}
    for home, mine in homes.items():
        sq.update(zip(mine, rt.call(home, lambda *ts: [torch.sum(t * t) for t in ts],
                                    *[totals[p] for p in mine])))
    return rt.call(lead, lambda *xs: torch.sqrt(sum(xs)), *[sq[p] for p in totals])


def _update(rt, state: TrainState, flat: _Copies, grads, totals, cfg: TrainConfig, lead,
            draws: _Draws):
    """Clip, Adam, ``p - lr·u`` and the bias-corrected EMA: the norm, the
    lr and Adam's bias corrections on ``lead``, copied once to each card
    as one vector; then each card's update of its copies, the cards'
    updates free to overlap."""
    g_norm = _norm(rt, flat, totals, lead)
    opt = state.opt_state

    def scalars(g_norm, lr, count):
        xs = [g_norm, lr]
        if count is not None:
            count = count + 1
            xs += [_bias_correction(0.9, count), _bias_correction(0.999, count)]
        return torch.stack(xs), count

    vec, count = rt.call(lead, scalars, g_norm, state.lr, None if opt is None else opt.count)
    mu = nu = ema = None
    if opt is not None:
        mu, nu = _Copies(opt.mu), _Copies(opt.nu)
    if state.ema_params is not None:
        ema = _Copies(state.ema_params)
    n = len(flat.tensors)
    updates, new, new_mu, new_nu, new_ema = ([None] * n for _ in range(5))
    # the vector reaches every card before any card's update is issued: a copy
    # issued after one card's update would hold the next card's until it ends
    vecs = {card: rt.to(vec, card) for card in dict.fromkeys(flat.devices)}
    for card in dict.fromkeys(flat.devices):
        idx = [i for i, d in enumerate(flat.devices) if d == card]

        def update(vec, step_t, idx=idx):
            g_norm, lr = vec[0], vec[1]
            ups = [clip_to(grads[i], g_norm, cfg.max_gradient_norm) for i in idx]
            m = v = e = None
            if opt is not None:
                ups, m, v = adam_direction(ups, [mu.tensors[i] for i in idx],
                                           [nu.tensors[i] for i in idx], vec[2], vec[3])
            ps = [flat.tensors[i] - lr * u for i, u in zip(idx, ups)]
            if ema is not None:
                e = ema_update(cfg.ema_decay, [ema.tensors[i] for i in idx], ps, step_t)
            return ups, ps, m, v, e

        ups, ps, m, v, e = rt.call(card, update, vecs[card],
                                   None if draws.step_t is None else draws.step_t[card])
        for j, i in enumerate(idx):
            updates[i], new[i] = ups[j], ps[j]
            if m is not None:
                new_mu[i], new_nu[i] = m[j], v[j]
            if e is not None:
                new_ema[i] = e[j]
    if cfg.norm_metric == "update":
        first = {}
        for g, u in zip(flat.groups, updates):
            first.setdefault(g, u)
        gnorm = _norm(rt, flat, first, lead)
    elif cfg.norm_metric == "grad":
        gnorm = g_norm
    else:
        gnorm = rt.call(lead, lambda: torch.zeros((), dtype=torch.float32, device=lead))
    new_opt = None if opt is None else ScaleByAdamState(count=count, mu=mu.rebuild(new_mu),
                                                        nu=nu.rebuild(new_nu))
    new_state = TrainState(params=flat.rebuild(new), opt_state=new_opt, step=state.step + 1,
                           lr=state.lr, ema_params=None if ema is None else ema.rebuild(new_ema),
                           mesh=state.mesh)
    return new_state, gnorm


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor of a state on a grid, each copy on its card, in a
    fixed order: params, Adam's count and moments, lr, EMA params."""
    opt = state.opt_state
    adam = [] if opt is None else [opt.count, *_Copies(opt.mu).tensors, *_Copies(opt.nu).tensors]
    ema = [] if state.ema_params is None else _Copies(state.ema_params).tensors
    return [*_Copies(state.params).tensors, *adam, state.lr, *ema]


def state_cards(state: TrainState) -> List[torch.device]:
    """The card of each of ``state_tensors(state)``."""
    lead = state.mesh.local_devices[0]
    opt = state.opt_state
    adam = [] if opt is None else [lead, *_Copies(opt.mu).devices, *_Copies(opt.nu).devices]
    ema = [] if state.ema_params is None else _Copies(state.ema_params).devices
    return [*_Copies(state.params).devices, *adam, lead, *ema]


def with_tensors(state: TrainState, tensors: List[torch.Tensor], step: int) -> TrainState:
    """``state``'s structure over ``tensors`` (``state_tensors`` order)."""
    it = iter(tensors)
    take = lambda tree: _Copies(tree).rebuild([next(it) for _ in _Copies(tree).tensors])  # noqa: E731
    params = take(state.params)
    opt = state.opt_state
    if opt is not None:
        opt = ScaleByAdamState(count=next(it), mu=take(opt.mu), nu=take(opt.nu))
    lr = next(it)
    ema = None if state.ema_params is None else take(state.ema_params)
    return TrainState(params=params, opt_state=opt, step=step, lr=lr, ema_params=ema,
                      mesh=state.mesh)


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


__all__ = ["copies_identical", "gather_state", "make_grid_step", "place_state", "state_cards",
           "state_tensors", "with_tensors"]
