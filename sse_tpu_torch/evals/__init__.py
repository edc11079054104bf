"""Evaluation layer: exact top-N retrieval accuracy (port of
``sse_tpu.evals``)."""

from sse_tpu_torch.evals.recall import Evaluator, recall_at_k
from sse_tpu_torch.evals.at_scale import evaluate_against_index

__all__ = ["Evaluator", "recall_at_k", "evaluate_against_index"]
