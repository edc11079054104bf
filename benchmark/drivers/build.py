"""Index builds: whole ``build_index`` calls over the configuration's
target space, back to back, each ending when its rows are on the card
(as ``Workspace.build_index`` waits for them before it saves; no save
here). The passages are host arrays, as the workspace passes them: token
ids uniform in the mix's range, lengths the quantiles of
``passage_lengths`` in an order drawn from the seed.

``correct``: rows of the last build in the window, drawn from the seed
(``check.rows``), against the plain float32 target tower over the same
tokens. ``row_gap``: the widest distance between a written row and the
reference's (both unit rows); a padding row that is not zero, or a
build that counts another number of rows, reads infinite.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict

import torch

from benchmark import traffic as mix
from benchmark import weights
from benchmark.drivers import INDEX_DTYPES, Phases, gap, program_model, sync
from benchmark.reference import model as ref


def target_space(config: Dict, mx: Dict, seed: int, device, length: int):
    """(lengths int32 [N] on the host, tokens int32 [N, length] on
    ``device``): the configuration's ``num_targets`` passages."""
    n = config["num_targets"]
    lens = mix.shuffled(mix.quantile_lengths(mx["passage_lengths"], n), mix.host_gen(seed, 3))
    toks = mix.tokens(lens, length, mx["token_ids"], mix.device_gen(seed, 4, device), device)
    return lens, toks


class Driver:
    def __init__(self, cell, seed: int, device: torch.device, span) -> None:
        self.cell, self.seed, self.device, self.span = cell, seed, device, span
        self.config, self.mix = cell.config, cell.traffic
        self.record: Dict = {}
        self.attempted = self.failed = 0

    def setup(self) -> None:
        from sse_tpu_torch.data.corpus import TargetSpace

        dev = self.device
        self.phases = Phases(dev)
        task, self.model_cfg, self.model = program_model(self.config)
        self.params = weights.make(self.model, self.seed, dev)
        self.dtype = INDEX_DTYPES[task.index_dtype]
        lens, toks = target_space(self.config, self.mix, self.seed, dev, task.max_seq_length)
        self.lens, self.toks = lens, toks
        n = lens.shape[0]
        ids = [str(i) for i in range(n)]
        self.space = TargetSpace(ids=ids, texts=ids, tokens=toks.cpu().numpy(),
                                 lengths=lens.numpy(), id_to_row={})
        self.phases.mark("weights and passages")
        self.index = self._build(None)  # builds the kernels; each build captures its own graph
        self.phases.mark("kernel library and a first build")

    def _build(self, stats):
        from sse_tpu_torch.index.sharded_index import build_index

        return build_index(self.params, self.model_cfg, self.space,
                           batch_size=self.mix["batch_size"], dtype=self.dtype, graph_stats=stats)

    def window(self, seconds: float) -> None:
        from sse_tpu_torch.utils.graphs import GraphStats

        stats = GraphStats()
        each = []
        t0 = t_end = time.perf_counter()
        while True:
            self.index = None  # the last build's rows go before the next is made
            with self.span("bench.build"):
                self.index = self._build(stats)
            with self.span("bench.sync"):
                sync(self.device)
            each.append(time.perf_counter() - t_end)
            t_end = time.perf_counter()
            if t_end - t0 >= seconds:
                break
        builds = len(each)
        self.attempted = builds
        self.record = {"builds": builds, "docs": self.space.num_targets, "each_s": each,
                       "tokens": int(self.lens.sum()), "window_s": t_end - t0,
                       "captures_s": [g["seconds"] for g in stats.log],
                       "tower": self.model["tower"]}

    def end_to_end(self) -> Dict[str, float]:
        rec = self.record
        rate = rec["builds"] * rec["docs"] / rec["window_s"]
        print(f"builds {rec['builds']} of {rec['docs']} docs in {rec['window_s']:.4f} s "
              f"(s a build: {' '.join(f'{x:.4f}' for x in rec['each_s'])}); docs/s {rate:.1f}",
              file=sys.stderr, flush=True)
        return {"index_docs_per_s": rate}

    def free(self) -> None:
        self.space = None
        gc.collect()

    def check(self, stand_in=None) -> Dict[str, Dict]:
        """The comparison with the reference; ``stand_in`` (a ``Precision``):
        the reference at that precision judged in the program's place."""
        limits = self.config["limits"]["build"]
        n = self.lens.shape[0]
        pick = torch.randperm(n, generator=mix.host_gen(self.seed, 7))[: self.mix["check"]["rows"]]
        tok, lens = self.toks[pick.to(self.device)], self.lens[pick].to(self.device)
        tower = self.params["tgt_tower" if "tgt_tower" in self.params else "src_tower"]
        want = ref.encode_blocks(tower, self.model["tower"], tok, lens, ref.exact())
        if stand_in is not None:
            got = ref.encode_blocks(tower, self.model["tower"], tok, lens, stand_in)
            bad = 0.0
        else:
            emb = self.index.emb
            got = emb[pick.to(emb.device)].float()
            bad = 0.0 if (self.index.num_real == n and not emb[n:].any()) else float("inf")
        return {"row_gap": {"value": gap(torch.linalg.norm(got - want, dim=1)) + bad,
                            "limit": limits["row_gap"]}}
