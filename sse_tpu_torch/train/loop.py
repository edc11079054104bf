"""Train state, train step and the outer training driver (port of
``sse_tpu/train/loop.py``).

One step: both towers forward, scaled-cosine similarity, the softmax-
with-negatives loss, backward (the GRU layers' backward is the
hand-written kernel on a CUDA device), clip-then-Adam, ``p - lr·u`` and
the bias-corrected EMA. The JAX package compiles a step into one XLA
program, and its driver chains ``steps_per_dispatch`` steps into one
program; here each step is its own sequence of launches, with no host
sync inside it, and ``train()`` runs one step per batch. What a chunk
decides in JAX (log, eval and mining-refresh steps, the lr sequence)
falls at the same steps, since chunks end exactly at those boundaries.
``steps_per_dispatch`` is mirrored but unused until a chunk is captured
as a CUDA graph (ROADMAP.md).

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
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from sse_tpu_torch.data.batching import Batch, BatchIterator
from sse_tpu_torch.data.corpus import EncodedPairs, TargetSpace
from sse_tpu_torch.models import sse
from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
from sse_tpu_torch.train import losses as losses_lib
from sse_tpu_torch.train.losses import LossConfig

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
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


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
    steps_per_dispatch: int = 8  # unused: one step per batch (see the module doc)


# ----------------------------------------------------------- optimizer
class ScaleByAdamState(NamedTuple):
    """optax.ScaleByAdamState's fields: updates so far, first and second
    moments (trees shaped like the params)."""

    count: int
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


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in float32, as optax computes it."""
    return float(np.float32(1.0) - np.power(np.float32(decay), np.float32(count)))


def scale_by_adam_update(
    grads: Tree, state: ScaleByAdamState, b1: float = 0.9, b2: float = 0.999,
    eps: float = 1e-8,
) -> Tuple[Tree, ScaleByAdamState]:
    """optax.scale_by_adam (eps_root 0): moments, bias correction with the
    incremented count, ``m̂ / (sqrt(v̂) + eps)``."""
    mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
    nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state.nu)
    count = state.count + 1
    c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
    updates = tree_map(lambda m, v: (m / c1) / (torch.sqrt(v / c2) + eps), mu, nu)
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
        return ScaleByAdamState(count=0, mu=zeros(), nu=zeros())

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


def ema_update(decay: float, ema: Tree, params: Tree, step: int) -> Tree:
    """The bias-corrected EMA after update ``step + 1``, stored corrected:
    ema_1 = params, and no weight stays on the init params
    (``loop.py:311-331``); the weights in float32 as the JAX step computes
    them."""
    d = np.float32(decay)
    t = np.float32(step) + np.float32(1.0)
    w_old = float(d * (np.float32(1.0) - np.power(d, t - np.float32(1.0))))
    denom = float(np.float32(1.0) - np.power(d, t))
    return tree_map(lambda e, p: (w_old * e + (1.0 - decay) * p) / denom, ema, params)


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


# ---------------------------------------------------------------- step
def make_train_step(
    model_cfg: SSEConfig,
    cfg: TrainConfig,
    packed_width: Optional[int] = None,
    num_label_cols: int = 1,
    sample_negatives: Optional[Callable[[int, int, int], torch.Tensor]] = None,
    mesh=None,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build the train step (see ``sse_tpu.train.loop.make_train_step``).

    ``step_fn(state, src, src_len, labels, weight, tgt_tokens, tgt_lens
    [, tgt_emb_cache, labels_multi])`` → (new state, metrics). With
    ``packed_width=L`` it takes one [B, L+3+(M-1)] int32 operand per
    batch (``pack_batch``).

    The uniform negatives of step s come from a generator seeded from
    (cfg.seed, s), so a resumed run draws what the unbroken run drew; the
    dropout generator is seeded from (cfg.seed ^ 0x0D0D0D, s), a disjoint
    stream. ``sample_negatives(step, num_targets, k)`` replaces the draw
    (parity tests inject the rows JAX drew).

    With ``mesh`` (a ``parallel.Mesh``) the step runs on that grid
    (``train.grid``): the state is one placed by ``grid.place_state``, and
    the batch operands are this process's rows of the global batch."""
    if mesh is not None:
        from sse_tpu_torch.train import grid

        step = grid.make_grid_step(model_cfg, cfg, mesh, sample_negatives)
        return step if packed_width is None else _packed(step, packed_width, num_label_cols)
    tx = make_optimizer(cfg)
    loss_cfg = cfg.loss
    use_dropout, merged_scan = step_plan(model_cfg, cfg)
    negatives = make_negatives(cfg, sample_negatives)

    def loss_fn(params, src, src_len, labels, weight, tgt_tokens, tgt_lens,
                step, tgt_emb_cache, labels_multi):
        dev = src.device
        drop = None
        if use_dropout:
            drop = torch.Generator(device=dev).manual_seed(
                _step_seed(cfg.seed ^ 0x0D0D0D, step)
            )
        labels = labels.long()
        if merged_scan:
            cand_rows = labels
            if loss_cfg.kind == "sampled":
                cand_rows = torch.cat([cand_rows, negatives(step, tgt_tokens.shape[0], dev)])
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
            with record_function("sse.train.mine"):
                hard = losses_lib.mine_hard_negative_rows(
                    src_emb, tgt_emb_cache, labels, loss_cfg.num_hard_negatives,
                    labels_multi=labels_multi,
                )
            cand_rows = torch.cat([cand_rows, hard])
        if loss_cfg.kind == "sampled":
            cand_rows = torch.cat([cand_rows, negatives(step, tgt_tokens.shape[0], dev)])
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
                tgt_emb_cache=None, labels_multi=None):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(state.params)]
        params = _unflatten(state.params, leaves)
        with record_function("sse.train.forward"):
            loss, acc = loss_fn(
                params, src, src_len, labels, weight, tgt_tokens, tgt_lens,
                state.step, tgt_emb_cache, labels_multi,
            )
        with record_function("sse.train.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        grads = _unflatten(state.params, grads)
        with torch.no_grad(), record_function("sse.train.update"):
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
                ema = ema_update(cfg.ema_decay, ema, new_params, state.step)
        new_state = TrainState(
            params=new_params, opt_state=opt_state, step=state.step + 1,
            lr=state.lr, ema_params=ema,
        )
        metrics = {"loss": loss.detach(), "accuracy": acc, "grad_norm": gnorm}
        return new_state, metrics

    if packed_width is None:
        return step_fn
    return _packed(step_fn, packed_width, num_label_cols)


def make_negatives(cfg: TrainConfig, sample_negatives=None):
    """``negatives(step, num_targets, device)``: the uniform negative rows
    of a step, from a generator on ``device`` seeded from (cfg.seed, step),
    the same rows on every device (or the injected ``sample_negatives``)."""
    k = cfg.loss.num_negatives

    def negatives(step: int, num_targets: int, device) -> torch.Tensor:
        if sample_negatives is not None:
            return sample_negatives(step, num_targets, k).to(device)
        gen = torch.Generator(device=device).manual_seed(_step_seed(cfg.seed, step))
        return losses_lib.sample_negative_rows(gen, num_targets, k)

    return negatives


def _packed(step_fn, packed_width: int, num_label_cols: int):
    """``step_fn`` taking one packed [B, L+3+(M-1)] int32 operand a batch."""
    l = packed_width
    extra = num_label_cols - 1

    def packed_step(state, packed, tgt_tokens, tgt_lens, tgt_emb_cache=None):
        labels = packed[:, l + 1]
        labels_multi = None
        if extra > 0:
            labels_multi = torch.cat([labels[:, None], packed[:, l + 3 : l + 3 + extra]], dim=1)
        return step_fn(
            state, packed[:, :l], packed[:, l], labels,
            packed[:, l + 2].view(torch.float32), tgt_tokens, tgt_lens,
            tgt_emb_cache, labels_multi,
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
    it = BatchIterator(
        train_pairs, cfg.batch_size, seed=cfg.seed, process_index=process_index,
        process_count=process_count, shuffle_window=cfg.shuffle_window or None,
    )
    tokens = torch.from_numpy(np.asarray(target_space.tokens)).to(dev)
    lengths = torch.from_numpy(np.asarray(target_space.lengths)).to(dev)
    tgt_tokens, tgt_lens = copies(tokens), copies(lengths)
    upload = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731

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
        """Boundary work after each step; acts only at exact multiples."""
        nonlocal tgt_emb_cache, window_losses, best, state, t0
        if mine and step % cfg.hard_negative_refresh == 0:
            tgt_emb_cache = encode_cache(state)
        if step % cfg.steps_per_checkpoint == 0:
            mean_loss = (
                float(torch.stack(window_losses).mean())
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
        for batch in it.epoch_batches(epoch, start=start):
            state, metrics = step_fn(
                state, upload(pack_batch(batch)), tgt_tokens, tgt_lens,
                tgt_emb_cache=tgt_emb_cache,
            )
            window_losses.append(metrics["loss"])
            step += 1
            boundaries(epoch)
    return state


__all__ = [
    "Optimizer",
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
