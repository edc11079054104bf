"""The one generator of traffic: token lengths and ids from the parameters
of a mix's file (``traffic/<mix>.json``).

Sizes are a fixed multiset: a distribution's ``n`` lengths are its
quantiles at (i + 0.5) / n, so every seed draws the same sizes, and the
seed only orders them and draws the token ids. A ``lognormal``
distribution has a ``median`` and a ``sigma``; a ``uniform`` one holds
every whole length from ``min`` to ``max`` alike; both are clipped to
[``min``, ``max``].
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def quantile_lengths(dist: Dict, n: int) -> torch.Tensor:
    """int32 [n]: the distribution's lengths at the quantiles (i + 0.5) / n,
    ascending."""
    p = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    lo, hi = dist["min"], dist["max"]
    if dist["kind"] == "lognormal":
        x = torch.exp(math.log(dist["median"]) + dist["sigma"] * torch.special.ndtri(p))
        x = torch.round(x)
    elif dist["kind"] == "uniform":
        x = torch.floor(lo + p * (hi - lo + 1))
    else:
        raise ValueError(f"unknown length distribution {dist['kind']!r}")
    return x.clamp(lo, hi).to(torch.int32)


def shuffled(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """``x`` in the order of a permutation drawn from ``gen`` (a CPU
    generator)."""
    return x[torch.randperm(x.shape[0], generator=gen)]


def tokens(lengths: torch.Tensor, width: int, ids: Dict, gen: torch.Generator,
           device) -> torch.Tensor:
    """int32 [N, width]: ids uniform in [``min``, ``max``) at each row's
    first ``lengths`` positions, 0 (the pad id) after. ``gen`` lives on
    ``device``."""
    n = lengths.shape[0]
    out = torch.randint(ids["min"], ids["max"], (n, width), generator=gen, device=device,
                        dtype=torch.int32)
    pos = torch.arange(width, device=device)[None, :]
    return torch.where(pos < lengths.to(device)[:, None], out, 0)


def spans(source: torch.Tensor, source_lengths: torch.Tensor, lengths: torch.Tensor,
          noise: float, ids: Dict, gen: torch.Generator) -> torch.Tensor:
    """int32 [N, width of ``source``]: each row a span of its source row
    (``source`` [N, width], its valid ``source_lengths``) from an offset
    drawn from ``gen``, wrapping round the source's valid tokens, cut to
    ``lengths``, each token replaced by a uniform id with probability
    ``noise``; 0 after the length. A question drawn from its passage."""
    n, width = source.shape
    dev = source.device
    src_len = source_lengths.to(dev).long()[:, None]
    off = (torch.rand((n, 1), generator=gen, device=dev) * src_len).long()
    pos = (off + torch.arange(width, device=dev)[None, :]) % src_len
    out = torch.gather(source, 1, pos)
    swap = torch.rand((n, width), generator=gen, device=dev) < noise
    out = torch.where(swap, torch.randint(ids["min"], ids["max"], (n, width), generator=gen,
                                          device=dev, dtype=source.dtype), out)
    return torch.where(torch.arange(width, device=dev)[None, :] < lengths.to(dev)[:, None], out, 0)


def host_gen(seed: int, stream: int) -> torch.Generator:
    """A CPU generator for one purpose (``stream``) of a run's seed."""
    return torch.Generator().manual_seed((seed * 1000003 + stream) & 0x7FFFFFFFFFFFFFFF)


def device_gen(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one purpose of a run's seed."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1000003 + stream) & 0x7FFFFFFFFFFFFFFF)
