"""Drivers: one module a kind of traffic (``query``, ``train``, ``build``),
each with a ``Driver(cell, seed, device, span)`` that sets the cell up
(``setup``), measures (``window(seconds)``), reports its end-to-end
values (``end_to_end``) and what the window did (``record``, read by the
metrics), frees the program's state (``free``) and compares what the
timed path produced with the plain reference (``check``)."""

from __future__ import annotations

import random
import time
from typing import Dict, List, Tuple

import torch

INDEX_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def program_model(config: Dict):
    """The program's model configuration (through its own preset type,
    ``TaskConfig``) and the plain description the weights and the
    reference read: {"towers": [...], "tower": {...sizes}}."""
    from sse_tpu_torch.configs import TaskConfig

    task = TaskConfig(**config["task"])
    model_cfg = task.model_config(task.vocab_size, config.get("num_targets", 0))
    tower = {"vocab_size": task.vocab_size, "embed_dim": task.embed_dim, "hidden": task.hidden,
             "encoding_dim": task.encoding_dim, "cell": task.cell, "readout": task.readout,
             "num_layers": task.num_layers}
    towers = ["src_tower", "tgt_tower"] if task.network_mode == "dual-encoder" else ["src_tower"]
    return task, model_cfg, {"towers": towers, "tower": tower}


class Completion:
    """A point in the card's stream that the host can wait for (on the CPU
    the work is done when it is issued)."""

    def __init__(self, device: torch.device) -> None:
        self.event = torch.cuda.Event() if device.type == "cuda" else None

    def record(self) -> None:
        if self.event is not None:
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def host_buffer(shape, dtype, device: torch.device) -> torch.Tensor:
    """A host tensor the card copies into asynchronously (pinned)."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


class Reservoir:
    """A uniform sample of ``size`` items from a stream of unknown length,
    drawn from ``seed``."""

    def __init__(self, size: int, seed: int) -> None:
        self.size, self.rng, self.seen = size, random.Random(seed), 0
        self.items: List[Tuple[int, object]] = []

    def wants(self) -> int:
        """The slot the next item takes, or -1 where it is not kept."""
        self.seen += 1
        if len(self.items) < self.size:
            return len(self.items)
        j = self.rng.randrange(self.seen)
        return j if j < self.size else -1

    def put(self, slot: int, item) -> None:
        if slot == len(self.items):
            self.items.append(item)
        else:
            self.items[slot] = item


class Phases:
    """Seconds of each part of a set-up, each ended by a sync of the card:
    what ``setup_s`` is made of (printed to standard error)."""

    def __init__(self, device: torch.device) -> None:
        self.device, self.t, self.parts = device, time.perf_counter(), {}

    def mark(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.parts[name] = now - self.t
        self.t = now


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def gap(values: torch.Tensor) -> float:
    """The largest element as a float (inf where any is not finite)."""
    if values.numel() == 0:
        return 0.0
    if not torch.isfinite(values).all():
        return float("inf")
    return float(values.max())
