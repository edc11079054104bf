"""Train state, train step and the outer training driver (port of
``sse_tpu/train/loop.py``).

One step: both towers forward, scaled-cosine similarity, the softmax-
with-negatives loss, backward (the recurrent layers' backward is the
hand-written kernel on a CUDA device), clip-then-Adam, ``p - lr·u`` and
the bias-corrected EMA, with no host sync inside it.

Dispatch chaining. The JAX package runs ``steps_per_dispatch`` steps as
one XLA program (``make_train_step(chain=K)``, a ``lax.scan``; on a grid
one SPMD program, the gradients reduced inside it, across hosts too).
Here the same call captures K steps on the cards and replays them: on
one card as one CUDA graph (``_GraphChain``: one upload of the packed
chunk, one launch of the graph); on a grid (``mesh=``) as
``_GridChain``, each card's share of the steps as graphs in that card's
pool and the copies between cards issued between their replays (one
graph, as on one card, where every grid entry of the process lies on
one card). Across processes the backend decides
(``parallel.distributed.captures``): over NCCL, one rank a card, each
rank's chunk is one graph with its collectives inside, and the ranks
agree on each capture (``utils.graphs.agree``); over gloo (ranks that
share a card, or the CPU) the chain runs its K steps eagerly, as a gloo
collective runs on the host, which no CUDA graph holds. On the CPU,
which only the tests ask for, the chain runs eagerly too.
``train()`` chunks as JAX's does: a chunk ends exactly at the next
checkpoint or mining-refresh step and never crosses an epoch; a full
chunk is one chain call, a short one runs as single steps. So chained
and unchained runs take the same steps, and log, eval and refresh steps
and the lr sequence fall at the same steps.

A replay cannot read the host, so what a step takes from its step
number lives on the device: Adam's ``count`` is an int32 tensor, the
EMA's weights come from a device step, and the random draws come from
generators. Step s draws its uniform negatives from a generator seeded
from (cfg.seed, s) and its dropout masks from one seeded from
(cfg.seed ^ 0x0D0D0D, s); a chain registers one generator of each kind
a position with its graph and seeds them before each replay, so the
draws of step s are a function of (seed, s) alone, chained or not, and
a run resumed mid-chunk draws what the unbroken run drew.

The step's three phases are ``torch.profiler`` ranges
(``sse.train.forward``, ``sse.train.backward``, ``sse.train.update``);
inside the forward, ``sse.tower.embed``, ``sse.train.mine`` and
``sse.train.loss`` mark the embedding lookup, the mining and the loss.
``chip_smoke.step_split`` charges each kernel to the innermost range it
was launched in, and a backward kernel to the range of the forward op
whose gradient it computes.

Parameters are plain nested dicts/lists of tensors (the JAX checkpoint
layout, see ``sse_tpu_torch.convert``); the functions below map over
their leaves in JAX's flattening order (sorted dict keys).
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import time
from contextlib import nullcontext
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sse_tpu_torch.data.batching import Batch, BatchIterator
from sse_tpu_torch.data.corpus import EncodedPairs, TargetSpace
from sse_tpu_torch.models import sse
from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
from sse_tpu_torch.ops import GraphLaunches
from sse_tpu_torch.parallel import distributed
from sse_tpu_torch.train import losses as losses_lib
from sse_tpu_torch.train.losses import LossConfig
from sse_tpu_torch.utils import graphs
from sse_tpu_torch.utils.profiling import span

Tree = Any


# --------------------------------------------------------------- trees
def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """Leaves in JAX's pytree order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """fn over corresponding leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)


def _unflatten(tree: Tree, leaves: List[torch.Tensor]) -> Tree:
    """``tree``'s structure with ``leaves`` (in tree_leaves order)."""
    return _build(tree, iter(leaves))


def _build(t: Tree, it) -> Tree:
    """``t``'s structure over the leaves ``it`` yields (no closure: a
    recursive one is a reference cycle that keeps the leaves alive until
    the cyclic collector runs, which is off while a chain records)."""
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, it) for v in t)
    return next(it)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(x * x) for x in tree_leaves(tree)))


# --------------------------------------------------------------- state
@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int  # updates applied so far (a host int: no device round trip)
    lr: torch.Tensor  # float32 scalar on the params' device (plateau-decayed)
    # bias-corrected EMA of params (TrainConfig.ema_decay > 0), else None;
    # inference uses it when present (inference_params)
    ema_params: Any = None
    # the ('data', 'model') grid the state lives on (train.grid.place_state):
    # its params, moments and EMA leaves are then parallel.mesh.Replicated
    # copies, and the target table a parallel.mesh.RowShards; None on one device
    mesh: Any = None


def inference_params(state: TrainState) -> Any:
    """The params every inference consumer (eval, index build, serving)
    should use: the EMA average when training keeps one, else the raw
    optimization params. A state on a grid gives them whole on its first
    device (the target table assembled)."""
    params = state.params if state.ema_params is None else state.ema_params
    if state.mesh is not None:
        from sse_tpu_torch.parallel.mesh import gather

        return gather(params, state.mesh.local_devices[0])
    return params


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Mirror of ``sse_tpu.train.loop.TrainConfig``: same fields, same
    defaults (see that class for what each one means)."""

    batch_size: int = 64
    learning_rate: float = 0.5
    learning_rate_decay_factor: float = 0.9
    max_gradient_norm: float = 5.0
    optimizer: str = "adam"  # adam | sgd
    loss: LossConfig = LossConfig()
    steps_per_checkpoint: int = 100
    max_epochs: int = 10
    seed: int = 0
    hard_negative_refresh: int = 500
    shuffle_window: int = 0
    ema_decay: float = 0.0
    norm_metric: str = "grad"  # grad | update | none
    steps_per_dispatch: int = 8  # steps a chain: one CUDA graph a chunk on a card


# ----------------------------------------------------------- optimizer
class ScaleByAdamState(NamedTuple):
    """optax.ScaleByAdamState's fields: updates so far (an int32 scalar
    tensor on the params' device, so that a replayed step counts on the
    device), first and second moments (trees shaped like the params)."""

    count: torch.Tensor
    mu: Tree
    nu: Tree


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Direction-only transform, like the optax chain it ports: ``update``
    returns the direction ``u``; the step applies ``p - lr·u`` so that
    plateau decay needs no state rebuild."""

    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any], Tuple[Tree, Any, torch.Tensor]]


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    """optax.clip_by_global_norm: ``(g / ‖g‖)·max_norm`` when ‖g‖ ≥ max,
    g unchanged otherwise (no epsilon, unlike clip_grad_norm_), chosen on
    the device without a host sync. Returns (clipped, ‖g‖)."""
    g_norm = global_norm(grads)
    return tree_map(lambda t: clip_to(t, g_norm, max_norm), grads), g_norm


def clip_to(t: torch.Tensor, g_norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """One leaf of clip_by_global_norm, given the global norm."""
    return torch.where(g_norm < max_norm, t, (t / g_norm) * max_norm)


def adam_count(count, device: torch.device | str) -> torch.Tensor:
    """Adam's update count (an int or a tensor) as the state holds it: an
    int32 scalar on ``device``."""
    return torch.as_tensor(count, dtype=torch.int32).to(device)


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """1 - decay**count in float32 on count's device, as optax computes
    it."""
    return 1.0 - torch.pow(decay, count.float())


def adam_direction(grads: Tree, mu: Tree, nu: Tree, c1: torch.Tensor, c2: torch.Tensor,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Adam's moments and ``m̂ / (sqrt(v̂) + eps)`` given the bias
    corrections ``c1``, ``c2`` (scalars; copied to each leaf's device):
    (direction, first moment, second moment)."""
    mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, mu)
    nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, nu)
    updates = tree_map(
        lambda m, v: (m / c1.to(m.device)) / (torch.sqrt(v / c2.to(v.device)) + eps), mu, nu)
    return updates, mu, nu


def scale_by_adam_update(
    grads: Tree, state: ScaleByAdamState, b1: float = 0.9, b2: float = 0.999,
    eps: float = 1e-8,
) -> Tuple[Tree, ScaleByAdamState]:
    """optax.scale_by_adam (eps_root 0): moments, bias correction with the
    incremented count, ``m̂ / (sqrt(v̂) + eps)``."""
    count = state.count + 1
    c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
    updates, mu, nu = adam_direction(grads, state.mu, state.nu, c1, c2, b1, b2, eps)
    return updates, ScaleByAdamState(count=count, mu=mu, nu=nu)


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    """clip_by_global_norm(max_gradient_norm), then scale_by_adam (b1 0.9,
    b2 0.999, eps 1e-8) or the identity for ``sgd``. ``update`` returns
    (direction, new state, raw gradient norm)."""
    adam = cfg.optimizer == "adam"

    def init(params):
        if not adam:
            return None
        zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
        return ScaleByAdamState(count=adam_count(0, tree_leaves(params)[0].device),
                                mu=zeros(), nu=zeros())

    def update(grads, state):
        clipped, g_norm = clip_by_global_norm(grads, cfg.max_gradient_norm)
        if not adam:
            return clipped, state, g_norm
        updates, state = scale_by_adam_update(clipped, state)
        return updates, state, g_norm

    return Optimizer(init=init, update=update)


def init_train_state(
    model_cfg: SSEConfig,
    cfg: TrainConfig,
    generator: Optional[torch.Generator] = None,
    device: torch.device | str = "cuda",
) -> TrainState:
    """Fresh params (from ``generator``, else one seeded with cfg.seed),
    optimizer state, step 0, lr = cfg.learning_rate, and an EMA copy of
    the params when cfg.ema_decay > 0."""
    if not 0.0 <= cfg.ema_decay < 1.0:
        # d=1.0 makes the bias-corrected EMA 0/0 from step 1
        raise ValueError(f"ema_decay must be in [0, 1), got {cfg.ema_decay}")
    gen = generator if generator is not None else torch.Generator().manual_seed(cfg.seed)
    params = sse.init_params(model_cfg, gen, device)
    return TrainState(
        params=params,
        opt_state=make_optimizer(cfg).init(params),
        step=0,
        lr=torch.tensor(cfg.learning_rate, dtype=torch.float32, device=device),
        ema_params=tree_map(torch.clone, params) if cfg.ema_decay > 0 else None,
    )


def ema_update(decay: float, ema: Tree, params: Tree, step: torch.Tensor) -> Tree:
    """The bias-corrected EMA after update ``step + 1`` (``step``: the
    updates before this one, a device int tensor), stored corrected:
    ema_1 = params, and no weight stays on the init params
    (``loop.py:311-331``); the weights in float32 on the device, as the
    JAX step computes them."""
    t = step.float() + 1.0
    w_old = decay * (1.0 - torch.pow(decay, t - 1.0))
    denom = 1.0 - torch.pow(decay, t)
    return tree_map(
        lambda e, p: (w_old.to(e.device) * e + (1.0 - decay) * p) / denom.to(e.device),
        ema, params)


def step_plan(model_cfg: SSEConfig, cfg: TrainConfig) -> Tuple[bool, bool]:
    """(dropout on, merged scan) for a step. Shared-encoder mode without
    mining: source and candidate rows ride ONE tower pass (the candidates
    do not depend on src_emb). The gate counts the global batch; its 1024
    rows are the JAX package's v5e measurement, not yet measured on the
    H100 (ROADMAP.md)."""
    loss_cfg = cfg.loss
    use_dropout = model_cfg.src_tower.dropout > 0 or (
        model_cfg.tgt_tower is not None and model_cfg.tgt_tower.dropout > 0
    )
    merged_rows = 2 * cfg.batch_size + (
        loss_cfg.num_negatives if loss_cfg.kind == "sampled" else 0
    )
    merged_scan = (
        model_cfg.mode == NetworkMode.SHARED_ENCODER
        and loss_cfg.kind in ("inbatch", "sampled")
        and loss_cfg.num_hard_negatives == 0
        and merged_rows <= 1024
    )
    return use_dropout, merged_scan


def _step_seed(seed: int, step: int) -> int:
    """A generator seed for one (stream seed, step) pair: distinct pairs
    give distinct seeds for seed, step < 2^32."""
    return ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)


def _dropout_seed(seed: int) -> int:
    """The dropout stream's seed, disjoint from the negatives' (``seed``)."""
    return seed ^ 0x0D0D0D


@dataclasses.dataclass
class _Draws:
    """What a step reads of its step number s: s on the host (the injected
    ``sample_negatives`` hook's argument), s as an int32 scalar on the
    device (the EMA's weights; None without an EMA), and its negatives'
    and dropout generators (None where the step draws none). A grid step
    takes ``step_t`` as a card → its scalar, and each generator as a data
    replica → one on the replica's card, all seeded alike."""

    step: int
    step_t: Any
    negatives: Any
    dropout: Any


# ---------------------------------------------------------------- step
def make_train_step(
    model_cfg: SSEConfig,
    cfg: TrainConfig,
    packed_width: Optional[int] = None,
    num_label_cols: int = 1,
    sample_negatives: Optional[Callable[[int, int, int], torch.Tensor]] = None,
    mesh=None,
    chain: int = 1,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build the train step (see ``sse_tpu.train.loop.make_train_step``).

    ``step_fn(state, src, src_len, labels, weight, tgt_tokens, tgt_lens
    [, tgt_emb_cache, labels_multi])`` → (new state, metrics). With
    ``packed_width=L`` it takes one [B, L+3+(M-1)] int32 operand per
    batch (``pack_batch``). With ``chain=K`` (packed only) it takes K of
    them, ``chain_fn(state, packed_k [K, B, W], tgt_tokens, tgt_lens
    [, tgt_emb_cache])``, runs the K steps and returns metrics stacked
    [K]: on a CUDA device as one captured CUDA graph (``_GraphChain``),
    elsewhere eagerly. Its state and metrics are the graph's buffers:
    valid until the next call of the chain function.

    The uniform negatives of step s come from a generator seeded from
    (cfg.seed, s), so a resumed run draws what the unbroken run drew; the
    dropout generator is seeded from (cfg.seed ^ 0x0D0D0D, s), a disjoint
    stream. ``sample_negatives(step, num_targets, k)`` replaces the draw
    (parity tests inject the rows JAX drew); a chain on a card refuses it.

    With ``mesh`` (a ``parallel.Mesh``) the step runs on that grid
    (``train.grid``): the state is one placed by ``grid.place_state``, and
    the batch operands are this process's rows of the global batch. A
    chain on a grid of cards in one process is captured (``_GridChain``;
    the function keeps one a chunk shape in ``.chains``), as it is across
    processes over NCCL (``distributed.captures()``: one graph a rank,
    its collectives inside); across processes over gloo it runs
    eagerly."""
    if chain > 1 and packed_width is None:
        raise ValueError("a chain of steps takes packed batches (packed_width)")
    tx = make_optimizer(cfg)
    loss_cfg = cfg.loss
    use_dropout, merged_scan = step_plan(model_cfg, cfg)
    sampled = loss_cfg.kind == "sampled"
    if mesh is not None:
        from sse_tpu_torch.train import grid

        step = grid.make_grid_step(model_cfg, cfg, mesh, sample_negatives)
        if packed_width is None:
            return step
        packed = _packed(step, packed_width, num_label_cols)
        if chain <= 1:
            return packed
        eager = _eager_chain(packed, chain)
        if mesh.multi_process and not distributed.captures():
            return eager  # gloo's collectives run on the host: no CUDA graph holds them
        chains: Dict[tuple, _GridChain] = {}

        def grid_chain_fn(state, packed_k, tgt_tokens, tgt_lens, tgt_emb_cache=None):
            if not _captures(mesh.local_devices[0]):
                return eager(state, packed_k, tgt_tokens, tgt_lens, tgt_emb_cache)
            if sampled and sample_negatives is not None:
                raise ValueError("a chain on a CUDA device cannot capture the sample_negatives hook")
            key = (tuple(packed_k.shape), *(None if x is None else tuple(_one(x).shape)
                                            for x in (tgt_tokens, tgt_lens, tgt_emb_cache)))
            chained = chains.get(key)
            if chained is None:
                chained = chains[key] = _GridChain(
                    packed, chain, cfg, sampled, use_dropout, state, packed_k, tgt_tokens,
                    tgt_lens, tgt_emb_cache)
            return chained(state, packed_k, tgt_tokens, tgt_lens, tgt_emb_cache)

        grid_chain_fn.chains = chains  # the captured chains, by shape
        return grid_chain_fn
    negatives = make_negatives(cfg, sample_negatives)

    def eager_draws(step: int, dev) -> _Draws:
        gen = lambda seed: torch.Generator(device=dev).manual_seed(  # noqa: E731
            _step_seed(seed, step))
        return _Draws(
            step=step,
            step_t=torch.full((), step, dtype=torch.int32, device=dev)
            if cfg.ema_decay > 0 else None,
            negatives=gen(cfg.seed) if sampled and sample_negatives is None else None,
            dropout=gen(_dropout_seed(cfg.seed)) if use_dropout else None,
        )

    def loss_fn(params, src, src_len, labels, weight, tgt_tokens, tgt_lens,
                draws, tgt_emb_cache, labels_multi):
        dev = src.device
        drop = draws.dropout
        labels = labels.long()
        if merged_scan:
            cand_rows = labels
            if sampled:
                cand_rows = torch.cat([cand_rows, negatives(draws.step, tgt_tokens.shape[0], dev,
                                                            draws.negatives)])
            ct, cl = tgt_tokens[cand_rows], tgt_lens[cand_rows]
            width = max(src.shape[1], ct.shape[1])
            pad = lambda t: torch.nn.functional.pad(t, (0, width - t.shape[1]))  # noqa: E731
            emb = sse.encode_source(
                params, model_cfg, torch.cat([pad(src), pad(ct)]),
                torch.cat([src_len, cl]), drop,
            )
            b = src.shape[0]
            return losses_lib.similarity_loss(
                loss_cfg, emb[:b], labels, weight, cand_emb=emb[b:],
                cand_rows=cand_rows, labels_multi=labels_multi,
            )
        src_emb = sse.encode_source(params, model_cfg, src, src_len, drop)
        if loss_cfg.kind == "full":
            return losses_lib.similarity_loss(
                loss_cfg, src_emb, labels, weight,
                tgt_all=sse.target_embeddings(params, model_cfg),
                labels_multi=labels_multi,
            )
        # candidates = batch positives ∪ mined hard negatives ∪ K uniform rows
        cand_rows = labels
        if loss_cfg.num_hard_negatives > 0 and tgt_emb_cache is not None:
            with span("train.mine"):
                hard = losses_lib.mine_hard_negative_rows(
                    src_emb, tgt_emb_cache, labels, loss_cfg.num_hard_negatives,
                    labels_multi=labels_multi,
                )
            cand_rows = torch.cat([cand_rows, hard])
        if sampled:
            cand_rows = torch.cat([cand_rows, negatives(draws.step, tgt_tokens.shape[0], dev,
                                                        draws.negatives)])
        if model_cfg.mode == NetworkMode.SOURCE_ENCODER_ONLY:
            cand_emb = sse.target_embeddings(params, model_cfg, rows=cand_rows)
        else:
            cand_emb = sse.target_embeddings(
                params, model_cfg, tokens=tgt_tokens[cand_rows],
                lengths=tgt_lens[cand_rows], dropout_generator=drop,
            )
        return losses_lib.similarity_loss(
            loss_cfg, src_emb, labels, weight, cand_emb=cand_emb,
            cand_rows=cand_rows, labels_multi=labels_multi,
        )

    def step_fn(state, src, src_len, labels, weight, tgt_tokens, tgt_lens,
                tgt_emb_cache=None, labels_multi=None, draws: Optional[_Draws] = None):
        if draws is None:  # else a captured chain's position: its generators, its step
            draws = eager_draws(state.step, src.device)
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(state.params)]
        params = _unflatten(state.params, leaves)
        with span("train.forward"):
            loss, acc = loss_fn(
                params, src, src_len, labels, weight, tgt_tokens, tgt_lens,
                draws, tgt_emb_cache, labels_multi,
            )
        with span("train.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        grads = _unflatten(state.params, grads)
        with torch.no_grad(), span("train.update"):
            updates, opt_state, g_norm = tx.update(grads, state.opt_state)
            if cfg.norm_metric == "update":
                gnorm = global_norm(updates)
            elif cfg.norm_metric == "grad":
                gnorm = g_norm
            else:
                gnorm = torch.zeros((), dtype=torch.float32, device=loss.device)
            new_params = tree_map(lambda p, u: p - state.lr * u, state.params, updates)
            ema = state.ema_params
            if ema is not None:
                ema = ema_update(cfg.ema_decay, ema, new_params, draws.step_t)
        new_state = TrainState(
            params=new_params, opt_state=opt_state, step=state.step + 1,
            lr=state.lr, ema_params=ema,
        )
        metrics = {"loss": loss.detach(), "accuracy": acc, "grad_norm": gnorm}
        return new_state, metrics

    if packed_width is None:
        return step_fn
    packed = _packed(step_fn, packed_width, num_label_cols)
    if chain <= 1:
        return packed
    eager = _eager_chain(packed, chain)
    chains: Dict[tuple, _GraphChain] = {}

    def chain_fn(state, packed_k, tgt_tokens, tgt_lens, tgt_emb_cache=None):
        dev = tree_leaves(state.params)[0].device
        if dev.type != "cuda":
            return eager(state, packed_k, tgt_tokens, tgt_lens, tgt_emb_cache)
        if sampled and sample_negatives is not None:
            raise ValueError("a chain on a CUDA device cannot capture the sample_negatives hook")
        key = (tuple(packed_k.shape), tuple(tgt_tokens.shape), tuple(tgt_lens.shape),
               None if tgt_emb_cache is None else tuple(tgt_emb_cache.shape))
        graph = chains.get(key)
        if graph is None:
            graph = chains[key] = _GraphChain(
                packed, chain, cfg.seed, sampled, use_dropout, state, packed_k, tgt_tokens,
                tgt_lens, tgt_emb_cache)
        return graph(state, packed_k, tgt_tokens, tgt_lens, tgt_emb_cache)

    return chain_fn


def _stacked(metrics: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Per-step metrics → each stacked with a leading [K] axis."""
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def _eager_chain(packed_step, k: int):
    """A chain's K steps one after the other (the CPU's and a grid's
    chain, and the plain version of a captured one)."""

    def chain_fn(state, packed_k, tgt_tokens, tgt_lens, tgt_emb_cache=None):
        if packed_k.shape[0] != k:
            raise ValueError(f"a chain of {k} steps got {packed_k.shape[0]} batches")
        metrics = []
        for i in range(k):
            state, m = packed_step(state, packed_k[i], tgt_tokens, tgt_lens, tgt_emb_cache)
            metrics.append(m)
        return state, _stacked(metrics)

    return chain_fn


def _state_leaves(state: TrainState) -> List[torch.Tensor]:
    """Every tensor of a one-device state, in a fixed order: params, Adam's
    count and moments, lr, EMA params."""
    opt = state.opt_state
    adam = [] if opt is None else [opt.count, *tree_leaves(opt.mu), *tree_leaves(opt.nu)]
    ema = [] if state.ema_params is None else tree_leaves(state.ema_params)
    return [*tree_leaves(state.params), *adam, state.lr, *ema]


def _with_leaves(state: TrainState, leaves: List[torch.Tensor], step: int) -> TrainState:
    """``state``'s structure over ``leaves`` (``_state_leaves`` order)."""
    it = iter(leaves)
    take = lambda tree: _unflatten(tree, [next(it) for _ in tree_leaves(tree)])  # noqa: E731
    params = take(state.params)
    opt = state.opt_state
    if opt is not None:
        opt = ScaleByAdamState(count=next(it), mu=take(opt.mu), nu=take(opt.nu))
    lr = next(it)
    ema = None if state.ema_params is None else take(state.ema_params)
    return TrainState(params=params, opt_state=opt, step=step, lr=lr, ema_params=ema)


class _GraphChain:
    """K steps captured as one CUDA graph for one set of input shapes (the
    counterpart of one XLA program a chunk), replayed once a call.

    The graph reads fixed buffers: the packed chunk, the target tokens,
    lengths and mining cache, every tensor of the state and the first
    step's number. Before each replay ``load`` fills them: the chunk by
    one upload (non-blocking from pinned memory) or a device copy; an
    input or a state tensor only where the caller passes another tensor
    than the buffer it was last copied into (a state the last replay
    returned is taken as it is; a state from eager steps, a rebound lr or
    a refreshed cache is copied in), and it seeds each position's
    generators for its step. The graph's last ops copy the K-th state into
    the state buffers, so the state a replay returns is those buffers.

    Capture follows PyTorch's whole-network recipe: one warm-up step on a
    side stream, then capture, with Python's cyclic collector off (as
    ``utils/graphs.py`` captures). A capture that fails raises."""

    def __init__(self, packed_step, k: int, seed: int, sampled: bool, dropout: bool,
                 state: TrainState, packed_k, tgt_tokens, tgt_lens, cache) -> None:
        dev = tree_leaves(state.params)[0].device
        self.packed_step, self.k, self.seed = packed_step, k, seed
        self.leaves = [torch.empty_like(x) for x in _state_leaves(state)]
        self.template = _with_leaves(state, self.leaves, 0)
        self.packed = torch.empty(tuple(packed_k.shape), dtype=torch.int32, device=dev)
        self.inputs = [None if x is None else torch.empty(x.shape, dtype=x.dtype, device=dev)
                       for x in (tgt_tokens, tgt_lens, cache)]
        self.seen: List[Any] = [None] * 3  # the caller's tensor each input buffer holds
        self.s0 = torch.zeros((), dtype=torch.int32, device=dev)
        gen = lambda on: torch.Generator(device=dev) if on else None  # noqa: E731
        self.gens = [(gen(sampled), gen(dropout)) for _ in range(k)]
        self.graph = torch.cuda.CUDAGraph()
        for g in itertools.chain(*self.gens):
            if g is not None:
                self.graph.register_generator_state(g)
        self.launches = GraphLaunches()
        self.load(state, packed_k, tgt_tokens, tgt_lens, cache)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._steps(1)  # warm-up: the captured code once, eagerly; dropped
        collecting = gc.isenabled()
        gc.disable()  # a graph or buffer the collector frees here would end the capture
        try:
            torch.cuda.current_stream(dev).wait_stream(side)
            with self.launches.capturing(), torch.cuda.graph(self.graph):
                final, self.metrics = self._steps(k)
                for buf, x in zip(self.leaves, _state_leaves(final)):
                    buf.copy_(x)
        finally:
            if collecting:
                gc.enable()

    def _steps(self, n: int):
        state = _with_leaves(self.template, self.leaves, 0)
        tokens, lengths, cache = self.inputs
        metrics = []
        for i in range(n):
            draws = _Draws(i, self.s0 + i, *self.gens[i])
            state, m = self.packed_step(state, self.packed[i], tokens, lengths, cache,
                                        draws=draws)
            metrics.append(m)
        return state, _stacked(metrics)

    def load(self, state: TrainState, packed_k, tgt_tokens, tgt_lens, cache) -> None:
        leaves = _state_leaves(state)
        if tuple(packed_k.shape) != tuple(self.packed.shape) or len(leaves) != len(self.leaves):
            raise ValueError("the chain's inputs do not match the captured graph's")
        self.packed.copy_(packed_k, non_blocking=packed_k.is_pinned())
        for j, x in enumerate((tgt_tokens, tgt_lens, cache)):
            if x is not self.seen[j]:
                self.inputs[j].copy_(x)
                self.seen[j] = x
        for buf, x in zip(self.leaves, leaves):
            if x is not buf:
                buf.copy_(x)
        self.s0.fill_(state.step)
        for i, (neg, drop) in enumerate(self.gens):
            if neg is not None:
                neg.manual_seed(_step_seed(self.seed, state.step + i))
            if drop is not None:
                drop.manual_seed(_step_seed(_dropout_seed(self.seed), state.step + i))

    def __call__(self, state: TrainState, packed_k, tgt_tokens, tgt_lens, cache):
        self.load(state, packed_k, tgt_tokens, tgt_lens, cache)
        self.graph.replay()
        self.launches.replayed()
        return _with_leaves(self.template, self.leaves, state.step + self.k), self.metrics


def _captures(dev: torch.device) -> bool:
    """Whether a grid's chain captures its steps: on a card."""
    return dev.type == "cuda"


def _one(x):
    """A tensor, or the first copy of a ``Replicated``."""
    return next(iter(x.values())) if isinstance(x, dict) else x


class _GridChain:
    """K steps of a grid captured on this process's cards for one set of
    input shapes (the counterpart of the one SPMD program a chunk that
    JAX compiles for a grid), replayed once a call.

    The steps read fixed buffers: every copy of every state tensor on its
    card, the packed chunk on the grid's first card (one upload, split
    over the replicas by copies between cards inside the chunk), a copy
    of the target tokens, lengths and mining cache on each card, and each
    card's step numbers. ``load`` fills them as ``_GraphChain.load``
    does (an input or a state tensor only where the caller passes another
    tensor than the one the buffer last took), writes each card's step
    numbers of the chunk (s + [0, K)), and seeds one negatives and one
    dropout generator a replica and a position for its step.

    The steps run as the grid step's per-card calls
    (``grid.make_grid_step``) recorded by a ``utils.graphs.Recorder``: each
    card's runs of work between copies become graphs in the card's pool,
    forward and backward alike, and the copies between cards are issued
    between the replays, so the host launches replays and copies and
    waits on nothing. Where every grid entry lies on one card there is no
    copy: the chunk is one graph (its generators all registered with it),
    as ``_GraphChain``'s (``split``: one graph a call of the step, a check
    of the graphs' order on one card). The last work of each card copies
    the K-th state into the buffers, so the state a replay returns is
    those buffers. One eager warm-up step on the cards' side streams
    comes first; a capture that fails raises.

    Across processes (NCCL, one card a rank) the rank's grid rows lie on
    its card: its chunk is one graph, the collectives of every step
    (``distributed.gather_rows``, ``sum_grads_over_ranks``, the gradient
    sums over 'data') inside it, in an order that follows from the config
    and the chunk's shape alone. Every rank warms up (each collective
    issued once eagerly) and records the same chunk, and the ranks agree
    on the recording before any replays it (``Recorder(agree=True)``)."""

    def __init__(self, packed_step, k: int, cfg: TrainConfig, sampled: bool, dropout: bool,
                 state: TrainState, packed_k, tgt_tokens, tgt_lens, cache,
                 split: bool = False) -> None:
        from sse_tpu_torch.parallel.mesh import Replicated
        from sse_tpu_torch.train import grid

        mesh = state.mesh
        self.grid, self.packed_step, self.k, self.seed = grid, packed_step, k, cfg.seed
        self.cards = mesh.local_devices
        self.lead = self.cards[0]
        self.ema = cfg.ema_decay > 0
        self.leaves = [torch.empty_like(x) for x in grid.state_tensors(state)]
        self.template = grid.with_tensors(state, self.leaves, 0)
        self.packed = torch.empty(tuple(packed_k.shape), dtype=torch.int32, device=self.lead)
        self.inputs = [None if x is None else Replicated(
            {c: torch.empty(_one(x).shape, dtype=_one(x).dtype, device=c) for c in self.cards})
            for x in (tgt_tokens, tgt_lens, cache)]
        self.seen: List[Any] = [None] * 3
        # each card's step numbers of the chunk's positions: s + [0, K)
        self.offsets = {c: torch.arange(k, dtype=torch.int32, device=c) for c in self.cards}
        self.steps = {c: torch.zeros(k, dtype=torch.int32, device=c) for c in self.cards}
        # this process's data replicas, each on the card of its grid row
        reps = {d: mesh.devices[d, 0] for d in range(mesh.shape["data"]) if mesh.is_local(d, 0)}
        gen = lambda on: {d: torch.Generator(device=c) for d, c in reps.items()} if on \
            else None  # noqa: E731
        self.gens = [(gen(sampled), gen(dropout)) for _ in range(k)]
        self.rec = graphs.Recorder(self.cards, split=split)
        self.rec.agree = mesh.multi_process  # the ranks agree on the recording
        self.load(state, packed_k, tgt_tokens, tgt_lens, cache)
        self.rec.warm(lambda: self._steps(graphs.EAGER, 1))
        whole = [g for pos in self.gens for kind in pos if kind for g in kind.values()]
        where = grid.state_cards(state)

        def run():
            one = self.rec.on(self.lead, whole) if len(self.cards) == 1 and not split \
                else nullcontext()
            with one:
                final, metrics = self._steps(self.rec, k)
                leaves = grid.state_tensors(final)
                for card in self.cards:
                    with self.rec.on(card):
                        for buf, x, at in zip(self.leaves, leaves, where):
                            if at == card:
                                buf.copy_(x)
            return metrics

        self.metrics = self.rec.record(run)
        self.launches = self.rec.launches

    def _steps(self, rec, n: int):
        state = self.grid.with_tensors(self.template, self.leaves, 0)
        tokens, lengths, cache = self.inputs
        metrics = []
        for i in range(n):
            step_t = {c: steps[i] for c, steps in self.steps.items()} if self.ema else None
            state, m = self.packed_step(state, self.packed[i], tokens, lengths, cache,
                                        draws=_Draws(i, step_t, *self.gens[i]), rec=rec)
            metrics.append(m)
        with rec.on(self.lead):
            return state, _stacked(metrics)

    def load(self, state: TrainState, packed_k, tgt_tokens, tgt_lens, cache) -> None:
        leaves = self.grid.state_tensors(state)
        if tuple(packed_k.shape) != tuple(self.packed.shape) or len(leaves) != len(self.leaves):
            raise ValueError("the chain's inputs do not match the captured graphs'")
        self.packed.copy_(packed_k, non_blocking=packed_k.is_pinned())
        for j, x in enumerate((tgt_tokens, tgt_lens, cache)):
            if x is not self.seen[j]:
                for c, buf in self.inputs[j].items():
                    buf.copy_(x[c] if isinstance(x, dict) else x)
                self.seen[j] = x
        for buf, x in zip(self.leaves, leaves):
            if x is not buf:
                buf.copy_(x)
        for c, steps in self.steps.items():
            torch.add(self.offsets[c], state.step, out=steps)
        for i, (neg, drop) in enumerate(self.gens):
            for g in (neg or {}).values():
                g.manual_seed(_step_seed(self.seed, state.step + i))
            for g in (drop or {}).values():
                g.manual_seed(_step_seed(_dropout_seed(self.seed), state.step + i))

    def __call__(self, state: TrainState, packed_k, tgt_tokens, tgt_lens, cache):
        self.load(state, packed_k, tgt_tokens, tgt_lens, cache)
        metrics = self.rec.replay()
        return self.grid.with_tensors(self.template, self.leaves, state.step + self.k), metrics


def make_negatives(cfg: TrainConfig, sample_negatives=None):
    """``negatives(step, num_targets, device, generator=None)``: the
    uniform negative rows of a step, from ``generator`` or else a
    generator on ``device`` seeded from (cfg.seed, step), the same rows on
    every device (or the injected ``sample_negatives``)."""
    k = cfg.loss.num_negatives

    def negatives(step: int, num_targets: int, device, generator=None) -> torch.Tensor:
        if sample_negatives is not None:
            return sample_negatives(step, num_targets, k).to(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(_step_seed(cfg.seed, step))
        return losses_lib.sample_negative_rows(generator, num_targets, k)

    return negatives


def _packed(step_fn, packed_width: int, num_label_cols: int):
    """``step_fn`` taking one packed [B, L+3+(M-1)] int32 operand a batch."""
    l = packed_width
    extra = num_label_cols - 1

    def packed_step(state, packed, tgt_tokens, tgt_lens, tgt_emb_cache=None, **kw):
        labels = packed[:, l + 1]
        labels_multi = None
        if extra > 0:  # a grid chain's recorder (``rec``) takes the operand's one kernel
            with kw.get("rec", graphs.EAGER).on(packed.device):
                labels_multi = torch.cat([labels[:, None], packed[:, l + 3 : l + 3 + extra]],
                                         dim=1)
        return step_fn(
            state, packed[:, :l], packed[:, l], labels,
            packed[:, l + 2].view(torch.float32), tgt_tokens, tgt_lens,
            tgt_emb_cache, labels_multi, **kw,
        )

    return packed_step


def pack_batch(batch: Batch) -> np.ndarray:
    """Fuse one batch into the single [B, L+3+(M-1)] int32 operand the
    packed step splits (``sse_tpu.train.loop.pack_batch``)."""
    parts = [
        batch.src,
        batch.src_len[:, None],
        batch.labels[:, None],
        np.ascontiguousarray(batch.weight, np.float32).view(np.int32).reshape(-1, 1),
    ]
    if batch.labels_multi is not None and batch.labels_multi.shape[1] > 1:
        parts.append(batch.labels_multi[:, 1:])
    return np.concatenate(parts, axis=1).astype(np.int32, copy=False)


# -------------------------------------------------------------- driver
def train(
    model_cfg: SSEConfig,
    cfg: TrainConfig,
    train_pairs: EncodedPairs,
    target_space: TargetSpace,
    *,
    eval_fn: Optional[Callable[[Any], Dict[str, float]]] = None,
    eval_metric: str = "recall@1",
    checkpoint_fn: Optional[Callable[[TrainState, int, Dict[str, Any]], None]] = None,
    log_fn: Optional[Callable[[Dict[str, Any]], None]] = None,
    state: Optional[TrainState] = None,
    process_index: int = 0,
    process_count: int = 1,
    mesh=None,
    device: torch.device | str = "cuda",
) -> TrainState:
    """The training driver, with ``sse_tpu.train.loop.train``'s semantics:
    resume skip (a restored state's step implies the epoch and the batches
    already consumed), the hard-negative cache refreshed every
    ``hard_negative_refresh`` steps, and every
    ``steps_per_checkpoint`` steps a log record, ``eval_fn`` on the
    inference params with plateau decay of ``lr``, ``checkpoint_fn`` and
    ``log_fn``. ``device`` places a fresh state; a given state stays
    where its params are.

    Steps run in chunks of ``cfg.steps_per_dispatch`` (JAX's
    ``loop.py:586-626``): a chunk ends at the next checkpoint or refresh
    step and within its epoch; a full chunk is one call of the chain
    step (on a card one CUDA graph replay, its batches uploaded once from
    pinned memory), a shorter one runs as single steps, and the boundary
    work runs once a chunk.

    With ``mesh`` (a ``parallel.Mesh``) the steps run on that grid
    (``train.grid``): a fresh state, or one on one device, is placed on it
    (``grid.place_state``), and one already there stays. With
    ``process_count > 1`` (a mesh is then required, as in JAX) each
    process feeds its slice of the global batch (``BatchIterator``) and
    holds whole grid rows; the ranks' slices, in rank order, make the
    global batch. ``eval_fn`` gets the inference params whole on this
    process's first device, on every process."""
    if process_count > 1 and mesh is None:
        raise ValueError("multi-process training requires a mesh")
    if state is None:
        state = init_train_state(
            model_cfg, cfg, device=device if mesh is None else mesh.local_devices[0])
    if mesh is not None:
        from sse_tpu_torch.parallel.mesh import Replicated
        from sse_tpu_torch.train.grid import place_state

        state = place_state(state, mesh)
        dev = mesh.local_devices[0]
        copies = lambda x: Replicated({d: x.to(d) for d in mesh.local_devices})  # noqa: E731
    else:
        dev = tree_leaves(state.params)[0].device
        copies = lambda x: x  # noqa: E731
    lm = getattr(train_pairs, "labels_multi", None)
    label_cols = 1 if lm is None else int(lm.shape[1])
    width = train_pairs.src.shape[1]
    step_fn = make_train_step(model_cfg, cfg, packed_width=width, num_label_cols=label_cols,
                              mesh=mesh)
    chain_k = max(1, cfg.steps_per_dispatch)
    chain_fn = make_train_step(
        model_cfg, cfg, packed_width=width, num_label_cols=label_cols, mesh=mesh, chain=chain_k,
    ) if chain_k > 1 else None
    it = BatchIterator(
        train_pairs, cfg.batch_size, seed=cfg.seed, process_index=process_index,
        process_count=process_count, shuffle_window=cfg.shuffle_window or None,
    )
    tokens = torch.from_numpy(np.asarray(target_space.tokens)).to(dev)
    lengths = torch.from_numpy(np.asarray(target_space.lengths)).to(dev)
    tgt_tokens, tgt_lens = copies(tokens), copies(lengths)
    upload = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    # a captured chain uploads its chunk itself: once, from pinned memory
    pinned = dev.type == "cuda" and (mesh is None or not mesh.multi_process
                                     or distributed.captures())
    upload_chunk = lambda a: torch.from_numpy(a).pin_memory() if pinned else upload(a)  # noqa: E731

    mine = cfg.loss.num_hard_negatives > 0 and cfg.loss.kind != "full"

    @torch.no_grad()
    def encode_cache(state):
        """The whole target-embedding cache, on every device of the grid."""
        params = inference_params(dataclasses.replace(state, ema_params=None))
        if model_cfg.mode == NetworkMode.SOURCE_ENCODER_ONLY:
            return copies(sse.target_embeddings(params, model_cfg))
        return copies(sse.target_embeddings(params, model_cfg, tokens=tokens, lengths=lengths))

    tgt_emb_cache = encode_cache(state) if mine else None

    best = -float("inf")
    window_losses: List[torch.Tensor] = []
    t0 = time.perf_counter()
    step = int(state.step)
    spe = max(it.steps_per_epoch, 1)
    start_epoch = min(step // spe, cfg.max_epochs)
    skip_batches = step % spe if start_epoch < cfg.max_epochs else 0

    def boundaries(epoch):
        """Boundary work after each chunk; acts only at exact multiples
        (a chunk ends at every boundary, so this is step-exact)."""
        nonlocal tgt_emb_cache, window_losses, best, state, t0
        if mine and step % cfg.hard_negative_refresh == 0:
            tgt_emb_cache = encode_cache(state)
        if step % cfg.steps_per_checkpoint == 0:
            mean_loss = (
                float(torch.cat([x.reshape(-1) for x in window_losses]).mean())
                if window_losses else float("nan")
            )
            window_losses = []
            record: Dict[str, Any] = {
                "step": step,
                "epoch": epoch,
                "loss": mean_loss,
                "lr": float(state.lr),
                "steps_per_sec": cfg.steps_per_checkpoint
                / max(time.perf_counter() - t0, 1e-9),
            }
            t0 = time.perf_counter()
            if eval_fn is not None:
                evals = eval_fn(inference_params(state))
                record.update(evals)
                score = evals.get(eval_metric, mean_loss)
                if score > best:
                    best = score
                else:  # the reference's plateau decay
                    state = dataclasses.replace(
                        state, lr=state.lr * cfg.learning_rate_decay_factor
                    )
            if checkpoint_fn is not None:
                checkpoint_fn(state, step, record)
            if log_fn is not None:
                log_fn(record)

    for epoch in range(start_epoch, cfg.max_epochs):
        start = skip_batches if epoch == start_epoch else 0
        batches = iter(it.epoch_batches(epoch, start=start))
        while True:
            # a chunk ends exactly AT the next boundary and never crosses it
            room = chain_k
            if chain_k > 1:
                room = min(room, cfg.steps_per_checkpoint - step % cfg.steps_per_checkpoint)
                if mine:
                    room = min(room, cfg.hard_negative_refresh - step % cfg.hard_negative_refresh)
            chunk = list(itertools.islice(batches, room))
            if not chunk:
                break
            if chain_fn is not None and len(chunk) == chain_k:
                state, metrics = chain_fn(
                    state, upload_chunk(np.stack([pack_batch(b) for b in chunk])), tgt_tokens,
                    tgt_lens, tgt_emb_cache=tgt_emb_cache,
                )
                # [K]: a replay's output buffer, rewritten by the next replay
                window_losses.append(metrics["loss"].clone())
            else:  # epoch tail, boundary remainder, or chaining off
                for batch in chunk:
                    state, metrics = step_fn(
                        state, upload(pack_batch(batch)), tgt_tokens, tgt_lens,
                        tgt_emb_cache=tgt_emb_cache,
                    )
                    window_losses.append(metrics["loss"])
            step += len(chunk)
            boundaries(epoch)
    return state


__all__ = [
    "Optimizer",
    "adam_count",
    "ScaleByAdamState",
    "TrainConfig",
    "TrainState",
    "clip_by_global_norm",
    "global_norm",
    "inference_params",
    "init_train_state",
    "make_optimizer",
    "make_train_step",
    "pack_batch",
    "scale_by_adam_update",
    "train",
]
