"""recall@k and the training-time Evaluator (port of
``sse_tpu/evals/recall.py``): encode the targets, score each batch of
eval sources in float32 against every (or a sampled subset of) target,
``torch.topk``, then compare the top rows with each example's label set
on the host. No kernel of the JAX package runs here (it uses
``lax.top_k``); the towers' kernels do.

As JAX runs two jitted programs of one shape each (``_encode_tgt_batch``
and ``_encode_and_topk``), the Evaluator pads its last source and target
batches to ``batch_size`` and runs two fixed-shape programs
(``utils.graphs.Program``): on a card each is one CUDA graph, captured on
the first call and replayed after, reading parameter buffers the
Evaluator owns (each call copies the caller's params in once); on the
CPU they run eagerly.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sse_tpu_torch.data.corpus import EncodedPairs, TargetSpace
from sse_tpu_torch.models import sse
from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
from sse_tpu_torch.train.loop import tree_leaves, tree_map
from sse_tpu_torch.utils import graphs
from sse_tpu_torch.utils.graphs import GraphStats, Program


def recall_at_k(
    top_rows: np.ndarray,  # [N, max_k] predicted target rows, best first
    label_sets: Sequence[Tuple[int, ...]],
    ks: Sequence[int] = (1, 10),
) -> Dict[str, float]:
    """Multi-label recall (a hit if ANY correct row is in the top k) and
    MRR@max(ks): the reciprocal rank of the first correct row, 0 if none."""
    out = {}
    n = len(label_sets)
    for k in ks:
        hits = sum(1 for i, labels in enumerate(label_sets) if set(top_rows[i, :k]) & set(labels))
        out[f"recall@{k}"] = hits / max(n, 1)
    kmax = min(max(ks), top_rows.shape[1]) if ks else top_rows.shape[1]
    rr = 0.0
    for i, labels in enumerate(label_sets):
        lset = set(labels)
        for rank, row in enumerate(top_rows[i, :kmax]):
            if row in lset:
                rr += 1.0 / (rank + 1)
                break
    out[f"mrr@{kmax}"] = rr / max(n, 1)
    return out


# Above this many targets a per-checkpoint eval re-encodes a target space
# whose cost rivals an index build: warn unless the caller samples.
LARGE_EVAL_WARN_TARGETS = 1_000_000


def _padded(tokens: np.ndarray, lengths: np.ndarray, bs: int) -> Tuple[np.ndarray, np.ndarray]:
    """Rows padded to a multiple of ``bs`` with zero tokens and length 1,
    as the JAX Evaluator pads its last batch."""
    pad = -len(tokens) % bs
    tokens, lengths = np.asarray(tokens), np.asarray(lengths)
    if pad:
        tokens = np.concatenate([tokens, np.zeros((pad, tokens.shape[1]), tokens.dtype)])
        lengths = np.concatenate([lengths, np.ones((pad,), lengths.dtype)])
    return tokens, lengths


class Evaluator:
    """The reference's sse_evaluator.Evaluator analog, on the params'
    device: encodes the target space on every call (params change during
    training), then scores the eval sources in batches of ``batch_size``.

    ``sample_targets=N`` scores against the union of every eval row's
    labels plus uniform distractors up to N rows (an optimistic bound for
    training-time monitoring; report final numbers on the full space).

    On a card, with ``capture`` (the default), each of its two programs is
    one CUDA graph (module docstring): a second ``evaluate`` with other
    param values captures nothing; a capture that fails raises.
    ``capture=False`` runs the same programs eagerly. ``graph_stats``
    counts captures and replays."""

    def __init__(
        self,
        model_cfg: SSEConfig,
        eval_pairs: EncodedPairs,
        target_space: TargetSpace,
        batch_size: int = 256,
        ks: Sequence[int] = (1, 10),
        sample_targets: Optional[int] = None,
        capture: bool = True,
    ):
        self.model_cfg = model_cfg
        self.pairs = eval_pairs
        self.tspace = target_space
        self.batch_size = batch_size
        self.ks = tuple(ks)
        t = target_space.num_targets
        self._subset: Optional[np.ndarray] = None
        if sample_targets and sample_targets < t:
            label_rows = np.asarray(
                sorted({r for s in eval_pairs.label_sets for r in s}), np.int64
            )
            need = max(sample_targets - len(label_rows), 0)
            if need:
                mask = np.ones(t, bool)
                mask[label_rows] = False
                pool = np.nonzero(mask)[0]
                fill = np.random.default_rng(0).choice(
                    pool, size=min(need, len(pool)), replace=False
                )
                subset = np.sort(np.concatenate([label_rows, fill]))
            else:
                subset = label_rows
            self._subset = subset.astype(np.int32)
        elif t >= LARGE_EVAL_WARN_TARGETS:
            print(
                f"[sse] WARNING: evaluating against {t:,} targets "
                "re-encodes the FULL target space every eval call (an "
                "index build per checkpoint). Pass "
                "--eval_sample_targets N for sampled training-time "
                "monitoring, or use `eval --use_index` through the "
                "serving path for the final number.",
                file=sys.stderr,
            )
        eff_t = t if self._subset is None else len(self._subset)
        self.max_k = min(max(ks), eff_t)
        self.capture = capture
        self.graph_stats = GraphStats()
        self._programs: Optional[_Programs] = None

    def _load(self, params) -> "_Programs":
        """The programs on the params' device (made on the first call
        there), with the caller's params copied in."""
        dev = params["src_tower"]["embed"].device
        p = self._programs
        if p is None or p.device != dev or not p.fits(params):
            p = self._programs = _Programs(self, params, dev, graphs.pool_for(dev, self.capture))
        p.load(params)
        return p

    @torch.no_grad()
    def encode_targets(self, params) -> torch.Tensor:
        """[T, D] float32 target embeddings (T: the targets, or the sampled
        subset). On a card this is the Evaluator's own buffer, which its
        next call overwrites."""
        return self._load(params).encode_targets()

    @torch.no_grad()
    def top_rows(self, params, tgt_emb: Optional[torch.Tensor] = None) -> np.ndarray:
        """Top max_k predicted target rows (global rows) for every eval
        source; a ``tgt_emb`` of the caller's is copied in."""
        p = self._load(params)
        rows = p.top_rows(p.encode_targets() if tgt_emb is None else tgt_emb)
        return rows if self._subset is None else self._subset[rows]

    def evaluate(self, params) -> Dict[str, float]:
        top = self.top_rows(params)
        ks = [k for k in self.ks if k <= self.tspace.num_targets]
        return recall_at_k(top, self.pairs.label_sets, ks)


_TOWERS = ("src_tower", "tgt_tower")  # the params the programs read


class _Programs:
    """An Evaluator's two programs on one device and the buffers they read:
    the padded source and target tokens (uploaded once), the towers'
    params, one [bs, L] batch of each side, the [T_pad, D] target buffer
    (T rounded up to ``batch_size``; the top-k scores only its first T
    rows, so padding rows are never picked) and the [N_pad, max_k] rows.

    - ``encode``: one target batch → [bs, D], copied into the target
      buffer (tower modes; source-encoder-only fills it from the table);
    - ``topk``: one source batch encoded and scored against the target
      rows → [bs, max_k] row indices, copied into the rows buffer.

    With a ``pool`` (a card) the programs read the towers' params from
    buffers of their own, which ``load`` fills; without one they read the
    caller's. The programs hold nothing that refers back to this object,
    so it is freed as soon as its Evaluator is, with no cycle left for the
    collector."""

    def __init__(self, ev: Evaluator, params, dev: torch.device, pool) -> None:
        cfg, bs, max_k = ev.model_cfg, ev.batch_size, ev.max_k
        self.cfg, self.bs, self.n, self.device = cfg, bs, ev.pairs.num_examples, dev
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        self.src, self.src_len = map(up, _padded(ev.pairs.src, ev.pairs.src_len, bs))
        self.seo = cfg.mode == NetworkMode.SOURCE_ENCODER_ONLY
        sub = ev._subset
        if self.seo:
            self.subset = None if sub is None else up(sub.astype(np.int64))
            t = params["target_table"].shape[0] if sub is None else len(sub)
        else:
            toks, lens = ev.tspace.tokens, ev.tspace.lengths
            if sub is not None:
                toks, lens = toks[sub], lens[sub]
            t = toks.shape[0]
            self.tgt_tok, self.tgt_len = map(up, _padded(toks, lens, bs))
        self.tgt = torch.zeros((-(-t // bs) * bs, cfg.encoding_dim), dtype=torch.float32,
                               device=dev)
        view = self.view = self.tgt[:t]
        self.rows = torch.empty((self.src.shape[0], max_k), dtype=torch.int64, device=dev)
        self.own = None if pool is None else {
            k: tree_map(torch.empty_like, params[k]) for k in _TOWERS if k in params}
        read = self.read = {"params": self.own}  # the params the programs read
        self.given = params
        st, sl = self.src[:bs].clone(), self.src_len[:bs].clone()
        self.encode = None
        if not self.seo:
            tt, tl = self.tgt_tok[:bs].clone(), self.tgt_len[:bs].clone()
            self.encode = Program(
                lambda: sse.target_embeddings(read["params"], cfg, tokens=tt, lengths=tl),
                pool, ev.graph_stats, ("encode", tuple(tt.shape)))
            self.encode_in = (tt, tl)
        self.topk = Program(
            lambda: torch.topk(sse.encode_source(read["params"], cfg, st, sl).float()
                               @ view.float().t(), max_k, dim=1).indices,
            pool, ev.graph_stats, ("topk", tuple(st.shape), t))
        self.topk_in = (st, sl)

    def fits(self, params) -> bool:
        """Whether ``params`` has the towers this device's buffers hold."""
        if self.own is None:
            return True
        mine = tree_leaves(self.own)
        theirs = tree_leaves({k: params[k] for k in self.own if k in params})
        return len(mine) == len(theirs) and all(
            a.shape == b.shape and a.dtype == b.dtype for a, b in zip(mine, theirs))

    def load(self, params) -> None:
        self.given = params
        if self.own is None:
            self.read["params"] = params
            return
        for buf, x in zip(tree_leaves(self.own), tree_leaves({k: params[k] for k in self.own})):
            buf.copy_(x)

    def encode_targets(self) -> torch.Tensor:
        if self.seo:
            emb = sse.target_embeddings(self.given, self.cfg)
            self.view.copy_(emb if self.subset is None else emb[self.subset])
            return self.view
        bs = self.bs
        tt, tl = self.encode_in
        for lo in range(0, self.tgt.shape[0], bs):
            tt.copy_(self.tgt_tok[lo : lo + bs])
            tl.copy_(self.tgt_len[lo : lo + bs])
            self.tgt[lo : lo + bs].copy_(self.encode())
        return self.view

    def top_rows(self, tgt_emb: torch.Tensor) -> np.ndarray:
        if tgt_emb is not self.view:
            self.view.copy_(tgt_emb)
        bs = self.bs
        st, sl = self.topk_in
        for lo in range(0, self.rows.shape[0], bs):
            st.copy_(self.src[lo : lo + bs])
            sl.copy_(self.src_len[lo : lo + bs])
            self.rows[lo : lo + bs].copy_(self.topk())
        # one device→host copy at the end
        return self.rows[: self.n].cpu().numpy()
