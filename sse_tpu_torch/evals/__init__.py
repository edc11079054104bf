"""Evaluation layer: exact top-N retrieval accuracy (port of
``sse_tpu.evals``; ``evaluate_against_index`` from ``at_scale.py`` is
not ported yet, see ROADMAP.md)."""

from sse_tpu_torch.evals.recall import Evaluator, recall_at_k

__all__ = ["Evaluator", "recall_at_k"]
