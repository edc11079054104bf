"""Query traffic: one closed-loop client sends batches of token ids to the
query function that ``QueryEngine.query`` calls (``build_fused_query_fn``:
on a card one CUDA graph a shape: encode, quantize, top-k, merge,
decode), each batch padded to the engine's length bucket, with up to
``in_flight`` batches outstanding; each batch's scores and rows are
copied to host memory before a later call can overwrite them.

The mix's file gives the batch, the batches in flight, the pool of
distinct requests and their lengths: the pool's ``pool x batch`` lengths
are the quantiles of ``query_lengths``, dealt to the requests in turn
(``arrange: spread``: every request holds nearly the same sizes) or by a
fixed permutation of the mix's own ``layout_seed`` (``arrange: fixed``:
the same requests for every seed). The run's seed orders the requests
and draws the token ids, the index rows and the weights.

``correct``: a sample of the window's answers, drawn from the seed
(``check``: answers kept, queries of each compared), against the plain
reference: the float32 tower over the same tokens, then every index row
scored in float32. ``score_gap``: the widest gap between a returned
score and the reference's score of the returned row; ``rank_gap``: the
widest gap by which the reference's score of the j-th returned row lies
below the reference's j-th best score.
"""

from __future__ import annotations

import gc
import statistics
import sys
import time
from typing import Dict

import torch

from benchmark import traffic as mix
from benchmark import weights
from benchmark.drivers import (INDEX_DTYPES, Completion, Phases, Reservoir, gap, host_buffer,
                               program_model, sync)
from benchmark.reference import model as ref
from benchmark.reference.topk import exact_topk, row_scores

ROW_ALIGN = 4096  # the index's row geometry for large indexes


def make_index(rows: int, dim: int, dtype: torch.dtype, gen: torch.Generator, device,
               block: int = 1 << 20) -> torch.Tensor:
    """Random unit rows drawn on ``device``, stored in ``dtype``, padded
    with zero rows to a multiple of ROW_ALIGN."""
    padded = -(-rows // ROW_ALIGN) * ROW_ALIGN
    out = torch.zeros((padded, dim), dtype=dtype, device=device)
    for lo in range(0, rows, block):
        hi = min(lo + block, rows)
        x = torch.randn((hi - lo, dim), generator=gen, device=device)
        out[lo:hi] = (x / torch.linalg.norm(x, dim=1, keepdim=True)).to(dtype)
    return out


class Driver:
    def __init__(self, cell, seed: int, device: torch.device, span) -> None:
        self.cell, self.seed, self.device, self.span = cell, seed, device, span
        self.config, self.mix = cell.config, cell.traffic
        self.record: Dict = {}
        self.attempted = self.failed = 0

    def setup(self) -> None:
        from sse_tpu_torch.serve.engine import QueryEngine, build_fused_query_fn

        dev, mx, serve = self.device, self.mix, self.config["serve"]
        self.phases = Phases(dev)
        task, model_cfg, self.model = program_model(self.config)
        self.params = weights.make(self.model, self.seed, dev)
        self.k, self.num_real = serve["k"], serve["index_rows"]
        self.index = make_index(self.num_real, task.encoding_dim, INDEX_DTYPES[task.index_dtype],
                                mix.device_gen(self.seed, 2, dev), dev)
        self.phases.mark("weights and index")
        self.fused = build_fused_query_fn(model_cfg, k=self.k, num_real=self.num_real,
                                          pallas_variant=serve["pallas_variant"])
        length = task.max_seq_length
        widths = [b for b in QueryEngine._BUCKETS if b < length] + [length]
        b, p = mx["batch"], mx["pool"]
        lens = mix.quantile_lengths(mx["query_lengths"], p * b)
        if mx["arrange"] == "spread":
            lens = lens.reshape(b, p).t()
        else:
            layout = torch.Generator().manual_seed(mx["layout_seed"])
            lens = lens[torch.randperm(p * b, generator=layout)].reshape(p, b)
        order_gen = mix.host_gen(self.seed, 1)
        lens = torch.stack([mix.shuffled(r, order_gen) for r in lens])
        self.order = torch.randperm(p, generator=order_gen).tolist()
        toks = mix.tokens(lens.reshape(-1), length, mx["token_ids"],
                          mix.device_gen(self.seed, 3, dev), dev).reshape(p, b, length)
        self.tokens, self.lengths, self.widths = [], [], []
        for r in range(p):
            w = next(x for x in widths if x >= int(lens[r].max()))
            t = host_buffer((b, w), torch.int32, dev)
            t.copy_(toks[r, :, :w])
            n = host_buffer((b,), torch.int32, dev)
            n.copy_(lens[r])
            self.tokens.append(t)
            self.lengths.append(n)
            self.widths.append(w)
        del toks
        self.token_sums = [int(n.sum()) for n in self.lengths]
        self.phases.mark("requests")
        # every shape this traffic sends, largest first: the capture, then a replay
        for w in sorted(set(self.widths), reverse=True):
            r = self.widths.index(w)
            for _ in range(2):
                vals, _ = self._call(r)
                vals.cpu()
        self.phases.mark("kernel library, captures and replays of each shape")
        slots = mx["in_flight"]
        self.vals_h = [host_buffer((b, self.k), torch.float32, dev) for _ in range(slots)]
        self.rows_h = [host_buffer((b, self.k), torch.int32, dev) for _ in range(slots)]
        self.done = [Completion(dev) for _ in range(slots)]
        self.sample = Reservoir(mx["check"]["answers"], self.seed)
        sync(dev)

    def _call(self, r: int):
        dev = self.device
        with self.span("bench.send"):
            tok = self.tokens[r].to(dev, non_blocking=True)
            n = self.lengths[r].to(dev, non_blocking=True)
        with self.span("bench.call"):
            return self.fused(self.params, self.index, tok, n, self.num_real)

    def window(self, seconds: float) -> None:
        slots, p = self.mix["in_flight"], len(self.order)
        pending = [None] * slots
        latency, host, tokens = [], [], 0

        def complete(slot: int) -> None:
            i, r, t_send = pending[slot]
            with self.span("bench.wait"):
                self.done[slot].wait()
            latency.append(time.perf_counter() - t_send)
            keep = self.sample.wants()
            if keep >= 0:
                self.sample.put(keep, (r, self.vals_h[slot].clone(), self.rows_h[slot].clone()))
            pending[slot] = None

        i = 0
        t0 = time.perf_counter()
        while True:
            slot = i % slots
            if pending[slot] is not None:
                complete(slot)
            if time.perf_counter() - t0 >= seconds:
                break
            r = self.order[i % p]
            with self.span("bench.request"):
                t_send = time.perf_counter()
                vals, rows = self._call(r)
                host.append(time.perf_counter() - t_send)
                with self.span("bench.copyout"):
                    self.vals_h[slot].copy_(vals, non_blocking=True)
                    self.rows_h[slot].copy_(rows, non_blocking=True)
                    self.done[slot].record()
            pending[slot] = (i, r, t_send)
            tokens += self.token_sums[r]
            i += 1
        for j in range(max(0, i - slots), i):
            if pending[j % slots] is not None:
                complete(j % slots)
        t_end = time.perf_counter()
        self.attempted = i
        self.record = {"dispatches": i, "batch": self.mix["batch"], "tokens": tokens,
                       "window_s": t_end - t0, "latency_s": latency, "host_s": host,
                       "index_rows": self.num_real, "k": self.k,
                       "row_bytes": self.index.element_size(), "tower": self.model["tower"]}

    def end_to_end(self) -> Dict[str, float]:
        rec = self.record
        lat = sorted(x * 1e3 for x in rec["latency_s"])
        pct = statistics.quantiles(lat, n=100, method="inclusive") if len(lat) > 1 else lat * 99
        qps = rec["dispatches"] * rec["batch"] / rec["window_s"]
        print(f"requests {rec['dispatches']} of {rec['batch']} queries in {rec['window_s']:.4f} s; "
              f"latency ms p50 {pct[49]:.4f} p95 {pct[94]:.4f} p99 {pct[98]:.4f} "
              f"(n={len(lat)}); host ms a call mean {1e3 * statistics.fmean(rec['host_s']):.4f}; "
              f"queries/s {qps:.1f}", file=sys.stderr, flush=True)
        return {"query_qps": qps, "query_p95_ms": pct[94]}

    def free(self) -> None:
        del self.fused
        gc.collect()

    def check(self, stand_in=None) -> Dict[str, Dict]:
        """The comparison with the reference; ``stand_in`` (a ``Precision``):
        the reference at that precision judged in the program's place."""
        dev, limits = self.device, self.config["limits"]["query"]
        exact = ref.exact()
        gen = mix.host_gen(self.seed, 7)
        per = self.mix["check"]["queries"]
        score_gaps, rank_gaps = [], []
        for r, vals, rows in self.sample.items:
            b = vals.shape[0]
            pick = torch.randperm(b, generator=gen)[: min(per, b)]
            tok = self.tokens[r][pick].to(dev)
            n = self.lengths[r][pick].to(dev)
            q = ref.encode(self.params["src_tower"], self.model["tower"], tok, n, exact)
            best, _ = exact_topk(q, self.index, self.num_real, self.k, exact)
            if stand_in is not None:
                q_low = ref.encode(self.params["src_tower"], self.model["tower"], tok, n, stand_in)
                got_v, got_r = exact_topk(q_low, self.index, self.num_real, self.k, stand_in)
            else:
                got_v, got_r = vals[pick].to(dev), rows[pick].to(dev).long()
            ok = (got_r >= 0) & (got_r < self.num_real)
            s = row_scores(q, self.index, got_r.clamp(0, self.num_real - 1), exact)
            bad = torch.where(ok, 0.0, float("inf"))
            score_gaps.append(gap((got_v - s).abs() + bad))
            rank_gaps.append(gap((best - s).clamp(min=0) + bad))
        out = {"score_gap": max(score_gaps, default=float("inf")),
               "rank_gap": max(rank_gaps, default=float("inf"))}
        return {k: {"value": v, "limit": limits[k]} for k, v in out.items()}
