"""Faults planted under the timed path, each a context manager that
patches the program while it is open: what a sound comparison must catch
(``benchmark/tests/test_benchmark_faults.py`` on the CPU,
``calibrate.py --fault`` at a cell's own size on the card)."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name: str, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def altered_answer():
    """Every query's best row replaced by the next row, where the top-k
    produces it."""
    from sse_tpu_torch.serve import engine

    def make(fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if kwargs.get("composites"):
                return out
            vals, rows = out
            return vals, torch.cat([rows[:, :1] + 1, rows[:, 1:]], 1)
        return wrapped

    with _patched(engine, "fused_score_topk", make), \
            _patched(engine, "fused_score_topk_twophase", make):
        yield


@contextlib.contextmanager
def altered_row():
    """One element of every index row moved, where the rows are stored."""
    from sse_tpu_torch.index import sharded_index

    def make(fn):
        def wrapped(x, dtype):
            y = fn(x, dtype).clone()
            y[:, 0] += 0.1
            return y
        return wrapped

    with _patched(sharded_index, "quantize_rows", make):
        yield


@contextlib.contextmanager
def half_build_batch():
    """The second half of each encoded sub-batch left out (zero rows)."""
    from sse_tpu_torch.models import sse

    def make(fn):
        def wrapped(*args, **kwargs):
            emb = fn(*args, **kwargs)
            half = emb.shape[0] // 2
            return torch.cat([emb[:half], torch.zeros_like(emb[half:])])
        return wrapped

    with _patched(sse, "target_embeddings", make):
        yield


@contextlib.contextmanager
def unchanged_state():
    """A train call that returns the state it was given."""
    from sse_tpu_torch.train import loop

    def make(fn):
        def wrapped(*args, **kwargs):
            step = fn(*args, **kwargs)

            def unchanged(state, *a, **k):
                _, metrics = step(state, *a, **k)
                return state, metrics
            return unchanged
        return wrapped

    with _patched(loop, "make_train_step", make):
        yield


@contextlib.contextmanager
def half_train_batch():
    """The loss's mean taken over the first half of the batch alone."""
    from sse_tpu_torch.train import losses

    def make(fn):
        def wrapped(logits, label_col, weight):
            keep = torch.arange(weight.shape[0], device=weight.device) < weight.shape[0] // 2
            return fn(logits, label_col, weight * keep)
        return wrapped

    with _patched(losses, "_weighted_ce", make):
        yield


@contextlib.contextmanager
def altered_token():
    """The first token of every question changed before the source tower."""
    from sse_tpu_torch.models import sse

    def make(fn):
        def wrapped(params, cfg, tokens, lengths, *a, **k):
            return fn(params, cfg, torch.cat([tokens[:, :1] % 7 + 2, tokens[:, 1:]], 1),
                      lengths, *a, **k)
        return wrapped

    with _patched(sse, "encode_source", make):
        yield


FAULTS = {
    "query": {"altered_answer": altered_answer},
    "build": {"altered_row": altered_row, "half_build_batch": half_build_batch},
    "train": {"unchanged_state": unchanged_state, "half_train_batch": half_train_batch,
              "altered_token": altered_token},
}
