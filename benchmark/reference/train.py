"""Plain PyTorch training of a dual encoder with a sampled softmax:
hard negatives mined from a cache of target embeddings, uniform
negatives, the scaled-cosine softmax with false negatives masked, the
clip by global norm, Adam and the bias-corrected EMA, in float32.

The semantics are those of the configuration (``sampled`` loss, optax's
``clip_by_global_norm`` then ``scale_by_adam``, ``p - lr·u``, an EMA
stored bias-corrected). A step's uniform negatives are the rows the
configuration's rule draws: a generator on the step's device seeded
from (seed, step), ``randint(0, T, (K,))``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark.reference.model import Precision, encode

MASKED = torch.finfo(torch.float32).min


def leaves(tree) -> List[torch.Tensor]:
    """Leaves in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def leaf_names(tree, prefix: str = "") -> List[str]:
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rebuild(v, it) for v in tree)
    return next(it)


def uniform_negatives(seed: int, step: int, num_targets: int, k: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(((seed & 0xFFFFFFFF) << 32)
                                                    | (step & 0xFFFFFFFF))
    return torch.randint(0, num_targets, (k,), generator=gen, device=device)


@torch.no_grad()
def mine(src_emb: torch.Tensor, cache: torch.Tensor, labels: torch.Tensor, n: int,
         prec: Precision) -> torch.Tensor:
    """The n best-scoring wrong targets of each example, [B·n]."""
    sims = prec.mm(src_emb, cache.t())
    own = torch.arange(cache.shape[0], device=cache.device)[None, :] == labels[:, None]
    return torch.topk(sims.masked_fill(own, -float("inf")), n, dim=1).indices.reshape(-1)


def loss(params: Dict, model: Dict, loss_cfg: Dict, batch: Dict, targets: Dict,
         cache: torch.Tensor, negatives: torch.Tensor, prec: Precision) -> torch.Tensor:
    tower = model["tower"]
    labels = batch["labels"].long()
    src = encode(params["src_tower"], tower, batch["tokens"], batch["lengths"], prec)
    cand = [labels]
    if loss_cfg["num_hard_negatives"]:
        cand.append(mine(src.detach(), cache, labels, loss_cfg["num_hard_negatives"], prec))
    cand.append(negatives)
    rows = torch.cat(cand)
    tgt = encode(params["tgt_tower"], tower, targets["tokens"][rows], targets["lengths"][rows],
                 prec)
    b = src.shape[0]
    cos = prec.mm(src, tgt.t())
    col = torch.arange(rows.shape[0], device=cos.device)[None, :]
    own = col == torch.arange(b, device=cos.device)[:, None]
    same = labels[:, None] == rows[None, :]
    logits = (loss_cfg["scale"] * cos).masked_fill(same & ~own, MASKED)
    logp = torch.log_softmax(logits, dim=-1)
    w = batch["weight"]
    return -(logp[torch.arange(b, device=cos.device), torch.arange(b, device=cos.device)]
             * w).sum() / w.sum().clamp(min=1.0)


def init_state(params: Dict) -> Dict:
    zeros = [torch.zeros_like(x) for x in leaves(params)]
    return {"params": [x.clone() for x in leaves(params)], "mu": zeros,
            "nu": [z.clone() for z in zeros], "ema": [x.clone() for x in leaves(params)],
            "count": 0}


def step(state: Dict, structure: Dict, model: Dict, train_cfg: Dict, batch: Dict,
         targets: Dict, cache: torch.Tensor, seed: int, step_no: int, prec: Precision
         ) -> Tuple[Dict, float, float]:
    """One step of ``state`` (``init_state``'s dict, leaves in sorted-key
    order of ``structure``): (new state, loss, global gradient norm)."""
    loss_cfg = train_cfg["loss"]
    ps = [x.detach().requires_grad_(True) for x in state["params"]]
    params = rebuild(structure, iter(ps))
    negatives = uniform_negatives(seed, step_no, targets["tokens"].shape[0],
                                  loss_cfg["num_negatives"], ps[0].device)
    value = loss(params, model, loss_cfg, batch, targets, cache, negatives, prec)
    grads = torch.autograd.grad(value, ps, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(ps, grads)]
    with torch.no_grad():
        g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
        clip = train_cfg["max_gradient_norm"]
        if float(g_norm) >= clip:
            grads = [g / g_norm * clip for g in grads]
        count = state["count"] + 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state["mu"])]
        nu = [(1 - b2) * g * g + b2 * v for g, v in zip(grads, state["nu"])]
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        lr = train_cfg["learning_rate"]
        new = [p - lr * ((m / c1) / (torch.sqrt(v / c2) + eps))
               for p, m, v in zip(state["params"], mu, nu)]
        d = train_cfg["ema_decay"]
        t = step_no + 1
        w_old, denom = d * (1 - d ** (t - 1)), 1 - d ** t
        ema = [(w_old * e + (1 - d) * p) / denom for e, p in zip(state["ema"], new)]
    out = {"params": new, "mu": mu, "nu": nu, "ema": ema, "count": count}
    return out, float(value.detach()), float(g_norm)


def norm_gaps(prog: List[torch.Tensor], ref: List[torch.Tensor], keep: List[bool]) -> float:
    """The widest gap between the program's and the reference's norm of a
    leaf, over the kept leaves, against the larger of that leaf's
    reference norm and the median kept leaf's."""
    norms = [float(torch.linalg.norm(r.float())) for r in ref]
    kept = sorted(n for n, k in zip(norms, keep) if k)
    if not kept:
        return math.nan
    median = kept[len(kept) // 2]
    gaps = [abs(float(torch.linalg.norm(p.float())) - n) / max(n, median)
            for p, n, k in zip(prog, norms, keep) if k]
    return max(gaps)
