"""Training: the program's chained train step (``make_train_step(chain=)``:
on a card one CUDA graph of ``chain`` steps) on packed chunks of question
/ passage pairs, with hard negatives mined from a target-embedding cache
encoded at set-up, as ``train()`` first encodes it, and up to
``in_flight`` chunks outstanding (each chunk's losses copied to host
memory).

The mix gives the chain, the chunks in flight, the pool of chunks and
the lengths: a batch's question lengths are the quantiles of
``question_lengths`` in an order drawn from the seed; the target space's
passage lengths those of ``passage_lengths``; labels are uniform over
the target space, and each question is a span of its passage with a
share ``question_noise`` of its tokens replaced, so that the pairs carry
a signal to learn. Set-up builds the train state from the seeded weights
and drives it through the first chunk (``pool[0]``) with the window's
own call; the window then steps the same state through the other
chunks in turn.

``correct``: the first chunk's steps against the plain reference, which
encodes its own cache and follows them from the same weights:
``first_loss_gap``, the relative gap of the first step's loss (the later
steps' losses swing with the hard negatives that rounding lets the two
sides mine differently); ``gnorm_gap``, the widest relative gap of a
step's global gradient norm; ``mu_gap``, ``delta_gap`` and
``ema_gap``, the widest gap between the program's and the reference's
norm of a leaf's first Adam moment, of its change over the chunk, and of
its EMA's change, against the larger of the reference's norm of that
leaf and of the median leaf. Leaves whose reference moment is under a
thousandth of the median leaf's are left out of the last three.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Dict

import torch

from benchmark import traffic as mix
from benchmark import weights
from benchmark.drivers import Completion, Phases, host_buffer, program_model, sync
from benchmark.drivers.build import target_space
from benchmark.reference import model as ref
from benchmark.reference import train as ref_train

CACHE_BLOCK = 65536  # target rows a cache encode takes at once


class Driver:
    def __init__(self, cell, seed: int, device: torch.device, span) -> None:
        self.cell, self.seed, self.device, self.span = cell, seed, device, span
        self.config, self.mix = cell.config, cell.traffic
        self.record: Dict = {}
        self.attempted = self.failed = 0

    def setup(self) -> None:
        from sse_tpu_torch.models import sse
        from sse_tpu_torch.train import loop

        dev, mx = self.device, self.mix
        self.phases = Phases(dev)
        task, model_cfg, self.model = program_model(self.config)
        self.chain = mx["chain"]
        self.train_cfg = dataclasses.replace(task.train_config(), seed=self.seed % (1 << 31),
                                             steps_per_dispatch=self.chain)
        params = weights.make(self.model, self.seed, dev)
        self.params0 = {k: loop.tree_map(torch.clone, v) for k, v in params.items()}
        length = task.max_seq_length
        self.lens, self.toks = target_space(self.config, mx, self.seed, dev, length)
        self.tgt_lens = self.lens.to(dev)
        n, b = self.lens.shape[0], task.batch_size
        self.phases.mark("weights and passages")
        with torch.no_grad():  # the cache at the initial weights, as train() encodes it
            self.cache = torch.cat([
                sse.target_embeddings(params, model_cfg, tokens=self.toks[lo : lo + CACHE_BLOCK],
                                      lengths=self.tgt_lens[lo : lo + CACHE_BLOCK])
                for lo in range(0, n, CACHE_BLOCK)])
        self.phases.mark("kernel library and the mining cache")
        qlen = mix.quantile_lengths(mx["question_lengths"], b)
        self.src_tokens = int(qlen.sum())  # every batch holds these lengths
        if mx["pool"] < 2:
            raise ValueError("the pool needs its first chunk for the check and one for the window")
        gen_h, gen_d = mix.host_gen(self.seed, 5), mix.device_gen(self.seed, 6, dev)
        chunks = []
        for _ in range(mx["pool"] * self.chain):
            lens = mix.shuffled(qlen, gen_h).to(dev)
            labels = torch.randint(0, n, (b,), generator=gen_d, device=dev, dtype=torch.int32)
            src = mix.spans(self.toks[labels], self.tgt_lens[labels], lens,
                            mx["question_noise"], mx["token_ids"], gen_d)
            weight = torch.ones((b,), dtype=torch.float32, device=dev).view(torch.int32)
            chunks.append(torch.cat([src, lens[:, None], labels[:, None], weight[:, None]], 1))
        packed = torch.stack(chunks).reshape(mx["pool"], self.chain, b, length + 3)
        self.pool = [host_buffer(c.shape, torch.int32, dev).copy_(c) for c in packed]
        self.phases.mark("chunks")
        self.step_fn = loop.make_train_step(model_cfg, self.train_cfg, packed_width=length,
                                            chain=self.chain)
        state = loop.TrainState(
            params=params, opt_state=loop.make_optimizer(self.train_cfg).init(params), step=0,
            lr=torch.tensor(self.train_cfg.learning_rate, dtype=torch.float32, device=dev),
            ema_params=loop.tree_map(torch.clone, params))
        state, metrics = self._step(state, 0)
        self.phases.mark("the first chunk: warm-up step, capture, replay")
        self.first = {"loss": metrics["loss"].clone(), "grad_norm": metrics["grad_norm"].clone(),
                      "params": [x.clone() for x in loop.tree_leaves(state.params)],
                      "mu": [x.clone() for x in loop.tree_leaves(state.opt_state.mu)],
                      "ema": [x.clone() for x in loop.tree_leaves(state.ema_params)]}
        self.state = state
        slots = mx["in_flight"]
        self.loss_h = [host_buffer((self.chain,), torch.float32, dev) for _ in range(slots)]
        self.done = [Completion(dev) for _ in range(slots)]
        sync(dev)

    def _step(self, state, chunk: int):
        with self.span("bench.chain"):
            return self.step_fn(state, self.pool[chunk], self.toks, self.tgt_lens,
                                tgt_emb_cache=self.cache)

    def window(self, seconds: float) -> None:
        slots, p = self.mix["in_flight"], len(self.pool)
        pending = [False] * slots
        bad = 0

        def complete(slot: int) -> int:
            with self.span("bench.wait"):
                self.done[slot].wait()
            pending[slot] = False
            return int((~torch.isfinite(self.loss_h[slot])).sum())

        i = 0
        state = self.state
        t0 = time.perf_counter()
        while True:
            slot = i % slots
            if pending[slot]:
                bad += complete(slot)
            if time.perf_counter() - t0 >= seconds:
                break
            state, metrics = self._step(state, 1 + i % (p - 1))
            with self.span("bench.copyout"):
                self.loss_h[slot].copy_(metrics["loss"], non_blocking=True)
                self.done[slot].record()
            pending[slot] = True
            i += 1
        for j in range(max(0, i - slots), i):
            if pending[j % slots]:
                bad += complete(j % slots)
        t_end = time.perf_counter()
        self.state = state
        b = self.pool[0].shape[1]
        self.attempted, self.failed = i * self.chain, bad
        mined = self.train_cfg.loss.num_hard_negatives
        negatives = self.train_cfg.loss.num_negatives
        self.record = {
            "steps": i * self.chain, "batch": b, "window_s": t_end - t0,
            "src_tokens": self.src_tokens,
            "cands": b + b * mined + negatives,
            "cand_tokens": float(b + b * mined + negatives) * float(self.lens.float().mean()),
            "num_targets": self.lens.shape[0], "mined": mined > 0,
            "tower": self.model["tower"]}

    def end_to_end(self) -> Dict[str, float]:
        rec = self.record
        rate = rec["steps"] * rec["batch"] / rec["window_s"]
        print(f"steps {rec['steps']} in {rec['window_s']:.4f} s "
              f"({1e3 * rec['window_s'] / max(rec['steps'], 1):.4f} ms a step); "
              f"examples/s {rate:.1f}", file=sys.stderr, flush=True)
        return {"train_examples_per_s": rate}

    def free(self) -> None:
        self.state = self.step_fn = None
        gc.collect()

    def check(self, stand_in=None) -> Dict[str, Dict]:
        """The comparison with the reference; ``stand_in`` (a ``Precision``):
        the reference at that precision judged in the program's place."""
        limits = self.config["limits"]["train"]
        exact = ref.exact()
        want = self._reference(exact)
        if stand_in is not None:
            got = self._reference(stand_in)
        else:
            first = self.first
            got = {"loss": first["loss"].tolist(), "gnorm": first["grad_norm"].tolist(),
                   "params": first["params"], "mu": first["mu"], "ema": first["ema"]}
        rel = lambda a, b: max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))  # noqa: E731
        p0 = ref_train.leaves(self.params0)
        mu_norms = [float(torch.linalg.norm(m)) for m in want["mu"]]
        median = sorted(mu_norms)[len(mu_norms) // 2]
        keep = [m >= 1e-3 * median for m in mu_norms]
        delta = lambda xs: [x - p for x, p in zip(xs, p0)]  # noqa: E731
        out = {
            "first_loss_gap": rel(got["loss"][:1], want["loss"][:1]),
            "gnorm_gap": rel(got["gnorm"], want["gnorm"]),
            "mu_gap": ref_train.norm_gaps(got["mu"], want["mu"], keep),
            "delta_gap": ref_train.norm_gaps(delta(got["params"]), delta(want["params"]), keep),
            "ema_gap": ref_train.norm_gaps(delta(got["ema"]), delta(want["ema"]), keep),
        }
        names = ref_train.leaf_names(self.params0)
        print("steps (loss, gradient norm), program | reference: " + "; ".join(
            f"{a:.6g} {b:.6g} | {c:.6g} {d:.6g}" for a, b, c, d in
            zip(got["loss"], got["gnorm"], want["loss"], want["gnorm"])), file=sys.stderr)
        print("leaves (first-moment norm, change norm), program | reference: " + "; ".join(
            f"{n}{'' if k else ' (left out)'} {float(torch.linalg.norm(gm)):.4g} "
            f"{float(torch.linalg.norm(gp - p)):.4g} | {float(torch.linalg.norm(wm)):.4g} "
            f"{float(torch.linalg.norm(wp - p)):.4g}"
            for n, k, gm, gp, wm, wp, p in zip(names, keep, got["mu"], got["params"], want["mu"],
                                               want["params"], p0)), file=sys.stderr, flush=True)
        return {k: {"value": v, "limit": limits[k]} for k, v in out.items()}

    def _reference(self, prec) -> Dict:
        """The reference's first chunk from the initial weights: each step's
        loss and gradient norm, and the leaves after it."""
        tower = self.model["tower"]
        cache = ref.encode_blocks(self.params0["tgt_tower"], tower, self.toks, self.tgt_lens,
                                  prec)
        targets = {"tokens": self.toks, "lengths": self.tgt_lens}
        state = ref_train.init_state(self.params0)
        chunk = self.pool[0].to(self.device)
        width = chunk.shape[2] - 3
        losses, gnorms = [], []
        for s in range(self.chain):
            packed = chunk[s]
            batch = {"tokens": packed[:, :width], "lengths": packed[:, width],
                     "labels": packed[:, width + 1],
                     "weight": packed[:, width + 2].view(torch.float32)}
            state, value, g_norm = ref_train.step(
                state, self.params0, {"tower": tower}, self._train_dict(), batch, targets,
                cache, self.train_cfg.seed, s, prec)
            losses.append(value)
            gnorms.append(g_norm)
        return {"loss": losses, "gnorm": gnorms, "params": state["params"], "mu": state["mu"],
                "ema": state["ema"]}

    def _train_dict(self) -> Dict:
        c = self.train_cfg
        return {"learning_rate": c.learning_rate, "max_gradient_norm": c.max_gradient_norm,
                "ema_decay": c.ema_decay,
                "loss": {"scale": c.loss.scale, "num_negatives": c.loss.num_negatives,
                         "num_hard_negatives": c.loss.num_hard_negatives}}
