"""Arithmetic the per-layer metric readers share: a layer's share of its
roofline, the window's share of the card's peak operations, the card's
idle share. Each returns None where it has nothing to read (an untraced
run, no kernel of the layer in the trace, a card without published
peaks), never 0 for a share."""

from __future__ import annotations

from typing import Iterable, Optional

from benchmark import work


def roofline_pct(run, kernels: Iterable[str], flops: float, nbytes: float) -> Optional[float]:
    """100 x the least time the card needs for the work / the summed device
    time of the layer's kernels in the traced window."""
    if run.trace is None:
        return None
    seconds = run.trace.seconds(kernels)
    bound = work.bound_seconds(flops, nbytes, run.kind)
    if not seconds or not bound:
        return None
    return 100.0 * bound / seconds


def mfu_pct(run, flops: float) -> Optional[float]:
    """100 x the model operations completed in the window / its seconds /
    the card's peak bf16 rate."""
    peak = work.peak_flops(run.kind)
    seconds = run.record.get("window_s")
    if run.trace is None or not peak or not seconds or not flops:
        return None
    return 100.0 * flops / seconds / peak


def idle_pct(run) -> Optional[float]:
    """100 x the part of the traced window in which nothing ran on the card."""
    if run.trace is None or not run.trace.window_s or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def query_topk_work(rec):
    w = work.score_topk(rec["batch"], rec["index_rows"], rec["tower"]["encoding_dim"], rec["k"],
                        rec["row_bytes"])
    return w["flops"] * rec["dispatches"], w["bytes"] * rec["dispatches"]


def query_model_flops(rec) -> float:
    return work.query_model_flops(rec["batch"] * rec["dispatches"], rec["tokens"],
                                  rec["index_rows"], rec["tower"])


def rnn_train_work(rec):
    """The recurrent layers of both towers, forward and backward, over the
    window's steps."""
    t = rec["tower"]
    parts = []
    for tokens, rows in ((rec["src_tokens"], rec["batch"]), (rec["cand_tokens"], rec["cands"])):
        for fn in (work.rnn_layer_fwd, work.rnn_layer_bwd):
            parts.append(fn(t["cell"], tokens, rows, t["embed_dim"], t["hidden"]))
    w = work.sum_work(parts)
    return w["flops"] * rec["steps"], w["bytes"] * rec["steps"]


def train_flops(rec) -> float:
    return rec["steps"] * work.train_step_flops(rec["tower"], rec["src_tokens"], rec["batch"],
                                                rec["cand_tokens"], rec["cands"],
                                                rec["num_targets"], rec["mined"])


def build_rnn_work(rec):
    t = rec["tower"]
    w = work.rnn_layer_fwd(t["cell"], rec["tokens"], rec["docs"], t["embed_dim"], t["hidden"])
    return w["flops"] * rec["builds"], w["bytes"] * rec["builds"]


def build_flops(rec) -> float:
    t = rec["tower"]
    return rec["builds"] * work.tower_fwd_flops(t["cell"], t["readout"], rec["tokens"], rec["docs"],
                                                t["embed_dim"], t["hidden"], t["encoding_dim"],
                                                t["num_layers"])
