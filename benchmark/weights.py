"""Seeded weights, made on the device in two draws, in the layout the
program and the reference both read: a tower is ``embed`` [V, E] (normal,
std 0.05), ``proj_w`` [H, D] (Glorot uniform), ``proj_b`` [D] (zeros),
with the attention readout ``attn_w`` [H, H] (Glorot), ``attn_b`` [H]
(zeros) and ``attn_v`` [H] (normal, 0.05), and a recurrent layer's fused
``w`` [(in+H), G·H] (a Glorot block for x and one for h) with ``b``
[G·H] (zeros)."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark.reference.model import GATES


def _tower_spec(t: Dict) -> List[Tuple[tuple, tuple, str, float]]:
    """(path, shape, draw, scale) of every leaf of one tower."""
    e, h, d = t["embed_dim"], t["hidden"], t["encoding_dim"]
    glorot = lambda a, b: math.sqrt(6.0 / (a + b))  # noqa: E731
    spec = [(("embed",), (t["vocab_size"], e), "normal", 0.05),
            (("proj_w",), (h, d), "uniform", glorot(h, d)),
            (("proj_b",), (d,), "zeros", 0.0)]
    if t["readout"] == "attention":
        spec += [(("attn_w",), (h, h), "uniform", glorot(h, h)),
                 (("attn_b",), (h,), "zeros", 0.0),
                 (("attn_v",), (h,), "normal", 0.05)]
    n = GATES[t["cell"]] * h
    for layer in range(t["num_layers"]):
        fan_in = e if layer == 0 else h
        spec += [(("layers", layer, "wx"), (fan_in, n), "uniform", glorot(fan_in, n)),
                 (("layers", layer, "wh"), (h, n), "uniform", glorot(h, n)),
                 (("layers", layer, "b"), (n,), "zeros", 0.0)]
    return spec


def make(model: Dict, seed: int, device) -> Dict:
    """The params of ``model`` (``towers``: the tower names, each with the
    tower's sizes) from ``seed``, on ``device``."""
    spec = [((name, *path), shape, draw, scale)
            for name in model["towers"] for path, shape, draw, scale in _tower_spec(model["tower"])]
    gen = torch.Generator(device=device).manual_seed(seed)
    total = {k: sum(math.prod(s) for _, s, d, _ in spec if d == k) for k in ("uniform", "normal")}
    flat = {"uniform": torch.rand(total["uniform"], generator=gen, device=device) * 2.0 - 1.0,
            "normal": torch.randn(total["normal"], generator=gen, device=device)}
    at = {"uniform": 0, "normal": 0}
    params: Dict = {}
    for path, shape, draw, scale in spec:
        n = math.prod(shape)
        if draw == "zeros":
            leaf = torch.zeros(shape, device=device)
        else:
            leaf = (flat[draw][at[draw] : at[draw] + n] * scale).reshape(shape)
            at[draw] += n
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    for name in model["towers"]:
        layers = params[name]["layers"]
        params[name]["layers"] = [
            {"w": torch.cat([layers[i]["wx"], layers[i]["wh"]]), "b": layers[i]["b"]}
            for i in sorted(layers)]
    return params
