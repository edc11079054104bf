"""recall@k and the training-time Evaluator (port of
``sse_tpu/evals/recall.py``): encode, score in float32 against every
(or a sampled subset of) target, ``torch.topk``, then compare the top
rows with each example's label set on the host. No kernel of the JAX
package runs here (it uses ``lax.top_k``)."""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sse_tpu_torch.data.corpus import EncodedPairs, TargetSpace
from sse_tpu_torch.models import sse
from sse_tpu_torch.models.sse import NetworkMode, SSEConfig


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


class Evaluator:
    """The reference's sse_evaluator.Evaluator analog, on the params'
    device: encodes the target space on every call (params change during
    training), then scores the eval sources in batches of ``batch_size``.

    ``sample_targets=N`` scores against the union of every eval row's
    labels plus uniform distractors up to N rows (an optimistic bound for
    training-time monitoring; report final numbers on the full space)."""

    def __init__(
        self,
        model_cfg: SSEConfig,
        eval_pairs: EncodedPairs,
        target_space: TargetSpace,
        batch_size: int = 256,
        ks: Sequence[int] = (1, 10),
        sample_targets: Optional[int] = None,
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

    @staticmethod
    def _device(params) -> torch.device:
        return params["src_tower"]["embed"].device

    @torch.no_grad()
    def encode_targets(self, params) -> torch.Tensor:
        cfg = self.model_cfg
        dev = self._device(params)
        if cfg.mode == NetworkMode.SOURCE_ENCODER_ONLY:
            emb = sse.target_embeddings(params, cfg)
            return emb if self._subset is None else emb[torch.from_numpy(self._subset).long().to(dev)]
        toks, lens = self.tspace.tokens, self.tspace.lengths
        if self._subset is not None:
            toks, lens = toks[self._subset], lens[self._subset]
        embs = []
        for lo in range(0, toks.shape[0], self.batch_size):
            t = torch.from_numpy(np.asarray(toks[lo : lo + self.batch_size])).to(dev)
            l = torch.from_numpy(np.asarray(lens[lo : lo + self.batch_size])).to(dev)
            embs.append(sse.target_embeddings(params, cfg, tokens=t, lengths=l))
        return torch.cat(embs)

    @torch.no_grad()
    def top_rows(self, params, tgt_emb: Optional[torch.Tensor] = None) -> np.ndarray:
        """Top max_k predicted target rows (global rows) for every eval
        source."""
        if tgt_emb is None:
            tgt_emb = self.encode_targets(params)
        dev = self._device(params)
        outs: List[torch.Tensor] = []
        for lo in range(0, self.pairs.num_examples, self.batch_size):
            s = torch.from_numpy(np.asarray(self.pairs.src[lo : lo + self.batch_size])).to(dev)
            sl = torch.from_numpy(np.asarray(self.pairs.src_len[lo : lo + self.batch_size])).to(dev)
            src_emb = sse.encode_source(params, self.model_cfg, s, sl)
            scores = src_emb.float() @ tgt_emb.float().t()
            outs.append(torch.topk(scores, self.max_k, dim=1).indices)
        rows = torch.cat(outs).cpu().numpy()  # one device→host copy at the end
        return rows if self._subset is None else self._subset[rows]

    def evaluate(self, params) -> Dict[str, float]:
        top = self.top_rows(params)
        ks = [k for k in self.ks if k <= self.tspace.num_targets]
        return recall_at_k(top, self.pairs.label_sets, ks)
