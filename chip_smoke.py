"""Smoke run of the PyTorch port on one CUDA GPU: serving and training,
GRU, LSTM and transformer towers, both top-k variants, and the model-dir
CLI.

    python3 chip_smoke.py            # needs one CUDA card; no network
    python3 chip_smoke.py --costs    # only the recurrences' per-step costs
    python3 chip_smoke.py --twophase # only the two-phase top-k's costs
    python3 chip_smoke.py --stream   # only the streaming top-k's costs
    python3 chip_smoke.py --bench    # only the query bench's sweep
    python3 chip_smoke.py --sharded  # only the sharded serving phase (7.)
    python3 chip_smoke.py --grid     # only the training-on-a-grid phase (8.)
    python3 chip_smoke.py --encode   # only the subword encoder's phase (3.)
    python3 chip_smoke.py --chain    # only the dispatch-chaining phase (9.)
    python3 chip_smoke.py --graphs   # only the served-graphs phase (10.)
    python3 chip_smoke.py --evals    # only the Evaluator / index-build graphs phase (11.)
    python3 chip_smoke.py --processes  # only the grids across processes over NCCL (12.)
    python3 chip_smoke.py --wide     # only the recurrent widths beyond E=H=128 (13.)
    python3 chip_smoke.py --embed-grad  # only the embedding table's gradient (14.)

``--costs`` (gru_fwd_costs, lstm_fwd_costs, rnn_bwd_costs for either
cell: each backward's kernels by part, and the products of
csrc/products.cu beside their byte bounds; and a served qna query by
part: qna_query_costs), ``--twophase``
(twophase_costs), ``--stream`` (stream_costs) and ``--bench``
(bench_sweep: the port's query bench at B=8..4096, k=10 and 100, bf16,
int8 and float32, a 10M-row index, both routes end to end) time the
``sse_tpu_torch`` beside this file: a copy of
this file in another checkout measures that checkout's kernels, so two
commits compare in one run, taken in turns.

1. Device check: a CUDA card is required (no CPU branch); prints the
   card's name and power limit (nvidia-smi) and the kernel build time.
2. Each Hopper kernel against its plain PyTorch version at the shapes of
   the paths below (T=50, E=H=128, ragged lengths): the GRU layer forward
   (B=8, 256, 384 and 4096) and the LSTM layer forward (B=8, 256 and 4096;
   fin to atol 2e-3 / rtol 1e-3, bf16 ys and cs to one bf16 ulp), and the
   recurrences' cost per step (gru_fwd_costs, lstm_fwd_costs,
   rnn_bwd_costs: the slope over T=1, 2, 50 of the kernels' device time;
   the LSTM forward by part, scan and x-product); the scan over
   precomputed pre-activations, GRU and LSTM (B=4096, the same bounds);
   the GRU and LSTM layer backward (B=128, 256, 384 and 2,304; end to
   end and at each rounding point, tolerances in check_bwd); the
   streaming top-k (B=8, the served interactive batch, and B=256; num_real
   0, 5, 127, 128, 129, 4095, 4096, 4097; zero and -0.0 query rows; the
   call under ``torch.cuda.set_sync_debug_mode("error")``) and the
   two-phase top-k phases (B=4096; B=1 and 1500; num_real 0, 5, 2047,
   2048, 2049 and T-1000; zero and -0.0 query rows) on the 1,249,280 x
   128 index, in bf16 and int8, the whole two-phase call under sync
   debug, its device time by part, against streaming at B=256 to 4096,
   and one engine bulk batch at B=4096 by kernel (twophase_costs); the
   exact top-k variant (B=8, 256 and 4096, bf16, int8 and f32, the same
   num_real edges and zero rows, sync debug, -0.0 products); all on
   exact-dot inputs, so that rows and values must match bit for bit. On
   random bf16 and int8 unit rows no B=4096 query row may rank apart
   between the two-phase and streaming routes (both score through one
   wgmma tile). The transformer tower (the ``transformer`` recipe's
   model) with the card's products against the same tower on
   ``bf16_matmul`` (check_transformer: B=256, states to 2e-2, gradients
   to 3e-2 of max-abs), its forward's cost at B=8, 256 and 4096 beside
   its FLOP bound with its GEMM kernels' names (no float32 GEMM may run),
   and one bulk B=4096 transformer query batch by part
   (transformer_costs).
3. The C++ subword encoder on the card machine's host (encode_slice):
   its build with the host compiler; the served corpus (below) built and
   encoded through it, its 1,248,280 documents at L=50 and the CPU
   tests' odd strings (unicode, escape blowup, lone surrogates, NUL, 300
   random) held against the plain Python encoder bit for bit, the token
   counts and three vocab builds too; batch_encode's host ms at B=8, 256
   and 4096, C++ beside Python; one bulk POST of 4,096 texts to the
   served GRU model split into tokenize, host to device, device and the
   rest, under the C++ and under the Python tokenizer (rows equal under
   both). Then the served slices (E=H=D=128, vocab 8000, L=50, random
   weights from a seed), each building the 1,249,280-row bf16 index on the GPU from the
   same 1,248,280 synthetic documents: (a) the bench model, a
   shared-encoder 1-layer GRU; (b) the ``qna`` configuration, a
   dual-encoder LSTM with the attention readout; (c) the GRU model with
   ``QueryEngine(pallas_variant="exact")``, which streams every batch;
   (d) the ``transformer`` recipe's model (dual-encoder, 4 pre-LN blocks,
   4 heads, RoPE), which launches no recurrent kernel.
   QueryEngine and warmup, the HTTP server on a free localhost port, GET
   (B=8 tier) and bulk POST queries (1,024 and 4,096 texts), the rows
   served held against topk_reference of the engine's variant, and every
   kernel's launch count from each run; a qna query's device time by
   part (query_parts: LSTM scan, x-product, attention readout, top-k).
4. The trained slices: (a) the train bench's setup (bench.train_setup:
   dual-encoder 1-layer GRU, E=H=D=128, vocab 8000, L=50, batch 256, 128
   sampled negatives over 10,000 random targets, Adam; the one that
   phase 6 times) and (b) the ``compositional`` recipe's towers (3-layer
   residual LSTM, dropout 0.1) in the same setup: warm ms/step, the step's device time split by the
   profiler range or op that launched each kernel (step_split), and the
   layer forward and backward launches a step (2 + 2 GRU; 6 + 6 LSTM);
   (c) the ``transformer`` recipe's towers in the same setup (no
   recurrent launch); (d) the ``ranking`` and (e) the ``qna`` task
   presets and (f) the ``ranking`` preset with the ``transformer`` recipe
   trained by ``sse_tpu_torch.train.train`` on their demo corpora with
   the Evaluator as eval_fn: finite, falling loss, rising recall@1 (the
   transformer with no recurrent launch), and their EMA params serve one
   query through QueryEngine whose rows match topk_reference.
5. The model-dir path, each command a ``python -m sse_tpu_torch.cli``
   subprocess (cli_slice): demo-data, train (ranking preset), index,
   eval, eval --use_index, visualize, bench --kind query over the model
   dir, serve with /api/add, /api/save, a second train and /api/reload.
6. The port's benchmark (bench_slice, ``sse_tpu_torch.bench``): the query
   bench at k=10 on the 1,249,280-row index (bf16 B=4096, 8 and 256,
   int8 B=4096), the train and index benches at the JAX bench's default
   shapes; each result as JSON, the kernels each run launched, the timed
   setup's first batch against topk_reference, the device's busy share of
   one B=8 and one B=4096 window.
7. Sharded serving (sharded_slice, ``sse_tpu_torch.parallel``): the
   bench's GRU model over 1,249,280 random unit rows made on the card,
   on (1, 2), (1, 4) and (2, 2) grids (every entry cuda:0 on a one-card
   machine, so the shards share the card; distinct cards in turn where
   there are more): bf16 and int8, B=8 (streaming a shard) and 4096
   (two-phase a shard), k=10 and 100, the exact variant at B=8. On one
   data replica the rows and values equal the unsharded call's bit for
   bit; on (2, 2) they equal it wherever a replica's q equals the whole
   batch's, equal the unsharded top-k of the replicas' own q everywhere,
   and hold against topk_reference where q differs. Each grid function
   captures one CUDA graph a distinct card, and its replays (every card
   replayed before the merge, under sync debug "error") equal the eager
   grid call bit for bit and launch each of its top-k kernels data x
   model times. Ms a call (CUDA events), device ms and each card's busy
   share of a window of 32 calls, replayed and eager, of the sharded and
   unsharded calls at B=8 and 4096 (shards sharing one card: not a
   multi-card speed); the bench's query setup on a (1, 2) grid; a (2, 2)
   engine served over HTTP (GET, POST of 4,096 texts, /api/stats)
   against topk_reference on the whole index; an add across a block
   boundary (no capture) and a delete from both blocks (captures only
   through its warmup; a call on the old RowShards runs eagerly) of a
   (1, 2) engine against the same on one device; two processes
   (``chip_smoke.py --sharded-rank R``) joined by ``parallel.distributed``
   (gloo on one card, NCCL on two) serving a (1, 2) grid across them,
   whose rows equal the single process's and whose two-process index
   save loads back equal; the grid build (GRU, bf16, 1,249,280 documents
   on (1, 2) and (1, 4): rows equal the one-card build's bit for bit,
   docs/s replayed and eager beside the one card's).
8. Training on a grid (train_grid_slice, ``train.grid`` and
   ``parallel.context``; grid entries as in 7.): the ranking preset at
   its widths (GRU, E=H=D=128, 128 sampled and 16 mined negatives,
   multi-label rows, B=256) 8 steps through train() on (2, 1) and (4, 1),
   each step held against the one-card step from the same state (loss and
   grad_norm within rtol 2e-4, Adam's moments within 3e-3 in the 2-norm,
   params and EMA within rtol 3e-3 / atol 3e-5 where Adam's update is
   conditioned, at most SKIP_SHARE of a leaf left out elsewhere:
   held_state), every copy identical, the GRU kernels
   launched data x one card's count a step (the main path's counts leave
   out the one-card steps it is held against), and the free-running
   runs' drift from the one-card run beside the one-card run's own drift
   from a 1e-7 nudge of its init; the
   classification preset (full softmax, dropout 0.1, EMA) with a
   1,249,280-row table, one step on (1, 2), (1, 4) and (2, 2) against one
   card, no allocation as large as a [B, T] logits tensor; the
   transformer recipe's tower (mean readout) at B=256, L=512 on 2 and 4
   context-parallel shards against the unsharded encode, forward and
   gradients; dryrun_multichip(4); two ranks through ``cli train
   --num_processes 2`` (GRU and transformer; gloo on one card, NCCL too on
   two) against one process, then ``index --cp_shards 2``. Each grid's
   ms a step and split by part, and each CP encode's ms (the entries
   queue on one card: checks of the path, not a multi-card speed). The
   grid's chained steps (grid_chains, ``make_train_step(mesh=,
   chain=8)``): the ranking preset on (2, 1) and (4, 1) and the
   classification preset with the 1,249,280-row table on (1, 2), (1, 4)
   and (2, 2), each captured (graphs a card, copies between cards,
   seconds and MiB a card), a replay held against 8 eager grid steps
   from one state (bit for bit where two eager runs are) whose steps are
   held against the one-card step from their input states, four replays
   under sync debug "error", every copy identical, the recurrent
   launches a replayed step data x the one-card step's, ms a step
   chained against eager over 48 batches and each card's busy share of 8
   replays; then the ranking preset through train() on a (2, 1) grid at
   steps_per_dispatch 8 against 1 (the same log steps and losses).
9. Dispatch chaining (chain_slice, ``make_train_step(chain=8)``: 8 train
   steps captured as one CUDA graph and replayed): the train bench's GRU,
   the compositional LSTM stack (dropout) and the transformer towers at
   the bench shape (E=H=D=128, B=256, 128 negatives, L=50), each with
   its capture time and memory, a replay from one state held against 8
   eager steps (bit for bit where eager runs are), replays under sync
   debug, the launches a replayed step equal to an eager step's, ms a
   step chained against eager and the device's busy share; then the
   ``ranking`` preset through train() at steps_per_dispatch 8 against 1
   (the same log steps, the launches of one warm-up step more).
10. The served query as CUDA graphs (graphs_slice: ``QueryEngine.warmup``
   captures every (batch tier, length bucket), ``build_fused_query_fn``
   replays one graph a shape): the bench's GRU model over 1,249,280 random
   unit rows at bf16 B=8, 256 and 4096, int8 B=4096 and the exact variant
   at B=8, the transformer recipe's model at B=8 and 4096, each warmed
   (tiers x buckets captures, each one's seconds and MiB), a dispatch of
   served texts replayed against the same call eager bit for bit, the
   launches of one replay, ms a dispatch through ``engine.query`` (host
   clock) and through the function (CUDA events), replayed and eager, and
   the device's busy share of a bench window, replayed and eager;
   /api/stats of the B=4096 engine (captures = tiers x buckets, one
   replay a dispatch); one served ``compositional`` query (3-layer
   residual LSTM) replayed against eager; 1,000 documents added in ten
   calls while a thread serves (no capture, each added text ranks its
   document first) and a delete's recapture, then replay == eager.
11. The Evaluator's and the index build's programs as CUDA graphs
   (evals_slice): the bench's GRU model over 1,249,280 random target
   texts (L=50, seeded numpy) and 4,096 eval sources, and the qna model
   over 262,144: the Evaluator replayed against ``capture=False`` bit for
   bit (2 captures on the first evaluate, 0 on a second with other
   params; encode_targets and top_rows ms each way; the graphs' seconds
   and MiB), ``build_index`` (bf16, 64 x 256-row chunks) replayed
   against eager bit for bit (docs/s each way, one capture a build);
   the ``ranking`` preset through train() at steps_per_dispatch 8 with
   the evals replayed against eager; the index bench replayed and
   eager; and the precision flags: ``_TensorCoreDot`` forward and
   backward, a served transformer query and the Evaluator replays in a
   fresh process (``--flags-probe``) under PyTorch's default flags
   against the same calls under the flags main sets, bit for bit.
12. Grids across processes over NCCL, a card a rank (process_chains;
   needs two cards, and takes four where there are: on one card it says
   so, and ``--processes`` runs the gloo runs of 7. and 8. instead): for
   n = 2 and 4, n rank processes (``chip_smoke.py --process-rank R n
   COORD``) run grid_chain_run on the ranking preset on (n, 1) and, at n
   = 2, the classification preset with the 1,249,280-row table on (2, 1)
   and (2, 2) (each rank's card both blocks of its row): the chain one
   graph a rank, its collectives inside, a replay against K eager steps
   of the same n-rank grid, the eager steps against the one-card step,
   every rank's state bits equal, replays under sync debug "error", ms a
   step chained and eager (the slowest rank), each card's busy share, the
   capture's seconds and MiB, kernels and collectives a replayed step,
   the device ms of ``sse.train.grad_sum``; then a (1, n) served grid
   (bf16 and int8, B=8 and 4096): replay == eager == the single
   process's unsharded rows bit for bit, ms a call replayed and eager.
   Then ``cli train --num_processes n`` at steps_per_dispatch 8 against
   1 (mp_chain_train). Each rank logs NCCL's version and
   ``TORCH_NCCL_ASYNC_ERROR_HANDLING`` (left at PyTorch's default).
13. The recurrent widths beyond E=H=128 (``ops/rnn.py`` ``layer_plan``):
   check_wide, in phase 2, holds the cluster instances against their
   plain versions at T=50, H=256 and 384 (the split GRU forward and the
   LSTM forward's cluster scan at B=4096, the GRU backward at B=384 and
   4096, the LSTM's at B=256 and 4096; Glorot weights; fin, ys and the
   backward as phase 2 bounds them) with their times, each cluster
   launch's tile (blocks, rows a cluster, waves), cuDNN's LSTM beside the
   LSTM rows (forward and backward, CUDA events and the device time of
   every kernel of a call) and the bounds; wide_slice, among the runs,
   trains the ranking preset at
   hidden 256 (50 steps through train(), then a query served and
   replayed), chains the compositional recipe at hidden 256, and trains
   the ranking preset at embed_dim 256 and at hidden 100, each with the
   plain recurrent layer barred from the card (OnTheKernels) and its
   instances' counters > 0. ``--costs`` ends with wide_costs (µs a step
   at H=256 beside H=128, with each cluster launch's tile).
14. The embedding table's gradient (embed_grad_slice, ``ops/embed.py``
   ``table_grad`` → ``csrc/embed_grad.cu``): at the ``qna-train`` cell's
   shapes (a step's 2,304 target rows and 128 questions of 50 tokens, pad
   id 0 past each length: passages 5-50, questions 5-30) and at the
   ``ranking`` preset's (the same rows, every token a uniform id), the
   kernel's table gradient against its plain mirror bit for bit and
   against PyTorch's ``index_put_(accumulate=True)`` (autograd's backward
   of ``table[tokens]``) within float32 rounding; the device ms a call of
   the kernels alone (ids sorted beforehand), of ``table_grad`` (with the
   sort) and of ``index_put_``, each beside the byte bound (the cotangent
   read once, the table gradient written once). Prints {"embed_grad":
   {...}} (before the encode line in the full run).
Each kernel's bound (the least time the card could take for the same
work: the larger of its bytes over 3.35 TB/s and its tensor-core
operations over 989 TFLOP/s bf16 or 1,979 TOP/s int8) is computed from
this run's inputs. The cuDNN LSTM (``torch.nn.LSTM`` in bf16, the +1
forget bias folded into its bias, full lengths) is timed beside the LSTM
kernels as their library yardstick; the port never calls it.

Any failure raises (non-zero exit). Before the last two lines, a JSON
line {"encode": {...}} holds phase 3's host readings and one
{"graphs": {...}} phase 10's readings and one {"evals": {...}} phase
11's. The line before
the last is a JSON object with each kernel's launches, error, times and bound (the
streaming kernels also by batch size: time, bound and the served runs'
launches at each B checked); the last line is {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import random
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

T_PAD = 1_249_280  # the bench index: 305 x 4096 rows
D = 128
K = 10
SEED = 0
# a torch.profiler reading that the profiler lost (profiled); the kernels
# line writes it as null
NOT_MEASURED = math.nan


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def no_nan(obj):
    """``obj`` with every NaN (NOT_MEASURED) float as None, so that it
    writes as strict JSON."""
    if isinstance(obj, float) and math.isnan(obj):
        return None
    if isinstance(obj, dict):
        return {k: no_nan(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [no_nan(v) for v in obj]
    return obj


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of fn() over reps calls after one warm call
    (CUDA events around the whole run)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def exact_dot(shape, gen) -> torch.Tensor:
    """Multiples of 1/16 in [-1, 1]: bf16-exact, and every float32
    partial sum of their products is exact, in any order."""
    return (torch.randint(-16, 17, shape, generator=gen, device="cuda") / 16.0).to(torch.bfloat16)


def unit_rows(n, gen) -> torch.Tensor:
    x = torch.randn((n, D), generator=gen, device="cuda")
    return x / torch.linalg.norm(x, dim=1, keepdim=True)


def same(name, got, want) -> float:
    """Bit-for-bit equality of (vals, rows) pairs; returns max |dv|."""
    (gv, gr), (wv, wr) = got, want
    if not torch.equal(gr, wr):
        bad = (gr != wr).nonzero()[:5].tolist()
        raise AssertionError(f"{name}: rows differ at {bad}")
    if not torch.equal(gv, wv):
        raise AssertionError(f"{name}: values differ, max {float((gv - wv).abs().max())}")
    return float((gv - wv).abs().max()) if gv.numel() else 0.0


# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s and dense tensor-core
# operations/s by operand type
PEAK = {"bytes": 3.35e12, "bf16": 989e12, "int8": 1979e12}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved: int, ops: float, kind: str = "bf16") -> dict:
    """The least time the card could take: each input read once and each
    output written once (``moved`` bytes) at the HBM rate, against the
    tensor-core operations at the peak rate of their type."""
    t_bytes = moved / PEAK["bytes"] * 1e3
    t_ops = ops / PEAK[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def ragged_mask(T: int, B: int, gen) -> torch.Tensor:
    lens = torch.randint(1, T + 1, (B,), generator=gen, device="cuda")
    return (torch.arange(T, device="cuda")[:, None] < lens).float()[:, None, :].contiguous()


def layer_weights(E: int, H: int, G: int, gen):
    wx = (torch.randn((E, G * H), generator=gen, device="cuda") * 0.08).bfloat16()
    wh = (torch.randn((H, G * H), generator=gen, device="cuda") * 0.08).bfloat16()
    b = torch.randn((G * H,), generator=gen, device="cuda") * 0.05
    return wx, wh, b


def hold_layer(name: str, got, want) -> tuple:
    """fin (float32) within the JAX package's tolerance; ys and cs are
    bfloat16, so a float32 carry that differs in its last bits by the
    order of the sums may round to the neighbouring bf16 value: one bf16
    ulp. Returns (max |d fin|, max |d bf16|, bf16 values that differ)."""
    (ys, fin, *cs), (rys, rfin, *rcs) = got, want
    torch.testing.assert_close(fin, rfin, atol=2e-3, rtol=1e-3, msg=lambda m: f"{name}: {m}")
    e_b, flips = 0.0, 0
    for g, w in ((ys, rys), *zip(cs, rcs)):
        torch.testing.assert_close(g.float(), w.float(), atol=2e-3, rtol=2.0**-7,
                                   msg=lambda m: f"{name}: {m}")
        e_b = max(e_b, float((g.float() - w.float()).abs().max()))
        flips += int((g != w).sum())
    return float((fin - rfin).abs().max()), e_b, flips


MARK = "spin_kernel"  # torch.cuda._sleep's kernel: a mark on the device timeline


def call_device_ms(calls: dict, reps: int = 10, tries: int = 4) -> dict:
    """Mean device ms of every kernel (and copy) that one call of each of
    ``calls`` (name → function) puts on the card, from one torch.profiler
    session that runs them in turns, each after a mark (torch.cuda._sleep,
    one thread for one cycle): an event counts for the call whose mark
    last preceded it on the device timeline. A session whose marks are
    not all there, or whose calls of one function left different numbers
    of events, is profiled again as profiled() does; NOT_MEASURED where
    every session lost records."""
    names = list(calls)
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, tries + 1):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                for fn in calls.values():
                    torch.cuda._sleep(1)
                    fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: e.time_range.start)
        ms, seen, at = dict.fromkeys(names, 0.0), [], -1
        for e in evs:
            if MARK in e.name:
                at += 1
                seen.append(0)
            elif at >= 0:
                ms[names[at % len(names)]] += e.time_range.elapsed_us() / 1000.0
                seen[at] += 1
        if len(seen) == reps * len(names) and all(
                len(set(seen[i::len(names)])) == 1 for i in range(len(names))):
            return {k: v / reps for k, v in ms.items()}
        warn(f"torch.profiler session {attempt} of {tries} of {names}: {len(seen)} marks "
             f"(want {reps * len(names)}), events after each {seen}")
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
    warn(f"torch.profiler lost records of {names} in {tries} sessions: not measured")
    return dict.fromkeys(names, NOT_MEASURED)


def cudnn_lstm(wx, wh, b) -> torch.nn.LSTM:
    """The library yardstick: torch.nn.LSTM (cuDNN) in bf16 with the same
    weights, gate order (i, f, g, o) and the +1 forget bias folded into
    its bias. It runs every row to full length (no mask)."""
    E, H = wx.shape[0], wh.shape[0]
    lstm = torch.nn.LSTM(E, H).to(device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(wx.t())
        lstm.weight_hh_l0.copy_(wh.t())
        bias = b.clone()
        bias[H : 2 * H] += 1.0
        lstm.bias_ih_l0.copy_(bias)
        lstm.bias_hh_l0.zero_()
    # cuDNN packs bf16 weights anew at every call (its flat buffer takes
    # fp16/fp32 only): a 0.26 MB copy inside each timed call
    return lstm


def slope_line(name: str, ms_by_t: dict) -> str:
    """The per-step cost and the fixed cost of a recurrence from its times
    at T=1 and T=50 (least squares over every T given): slope = ms per
    step, intercept = staging plus launch."""
    ts = sorted(ms_by_t)
    n = len(ts)
    mt, mm = sum(ts) / n, sum(ms_by_t.values()) / n
    slope = (sum((t - mt) * (ms_by_t[t] - mm) for t in ts)
             / sum((t - mt) ** 2 for t in ts))
    times = ", ".join(f"T={t} {ms_by_t[t]:.4f}" for t in ts)
    return (f"{name}: {times} ms; {1000.0 * slope:.3f} us a step, intercept "
            f"{mm - slope * mt:.4f} ms")


def parts_ms(run, parts: dict, reps: int = 10) -> dict:
    """Mean device ms that one run() spends in the kernels of each part:
    ``parts`` maps a name pattern to its part, and a kernel whose name
    holds a pattern counts for that part (torch.profiler, after a warm
    run)."""
    run()
    torch.cuda.synchronize()
    times = profiled(run, reps, want=tuple(parts))
    if times is None:
        return dict.fromkeys(parts.values(), NOT_MEASURED)
    out = dict.fromkeys(parts.values(), 0.0)
    for pat, part in parts.items():
        out[part] += sum(ms for k, ms in times.items() if pat in k) / reps
    return out


def kernel_ms(run, pattern, reps: int = 10) -> float:
    """Mean device ms that one run() spends in the kernels whose name holds
    ``pattern`` (or any pattern of a tuple)."""
    pats = (pattern,) if isinstance(pattern, str) else pattern
    return sum(parts_ms(run, {p: p for p in pats}, reps).values())


def gru_fwd_costs(card: str, Bs=(8, 256, 384, 4096), Ts=(1, 2, 50)) -> dict:
    """The GRU layer forward (``rnn.rnn_layer``, E=H=128, full lengths) at
    each (B, T): the kernel's device time (kernel_ms) and the whole call's
    (CUDA events, which at small T time the host's launch path); logs
    each B's per-step slope and intercept of both, and the bound at the
    largest T. Returns {B: {T: (kernel ms, call ms)}}."""
    from sse_tpu_torch.ops import rnn

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    E = H = 128
    wx, wh, b = layer_weights(E, H, 3, gen)
    out = {}
    for B in Bs:
        xs_all = torch.randn((max(Ts), B, E), generator=gen, device="cuda").bfloat16()
        out[B] = {}
        for T in Ts:
            xs = xs_all[:T].contiguous()
            mask = torch.ones((T, 1, B), device="cuda")
            run = lambda: rnn.rnn_layer(xs, mask, wx, wh, b)  # noqa: E731
            out[B][T] = (kernel_ms(run, "gru_fwd_kernel"), cuda_ms(run, reps=20))
        ys, fin = run()
        bnd = bound(nbytes(xs, mask, wx, wh, b, ys, fin), 2.0 * T * B * (E + H) * 3 * H)
        log(slope_line(f"gru_fwd B={B} E=H={H} kernel", {t: v[0] for t, v in out[B].items()})
            + "; whole call: " + slope_line("call", {t: v[1] for t, v in out[B].items()})
            + f"; bound at T={T} {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) [{card}]")
    return out


def lstm_fwd_costs(card: str, Bs=(8, 128, 256, 2304, 4096), Ts=(1, 2, 50)) -> dict:
    """The LSTM layer forward (kernel 3, ``rnn.rnn_layer``, E=H=128,
    ragged lengths) by part at each (B, T): the scan kernel's and the
    x-product's device time (parts_ms), and the scan alone with the GRU
    cell (kernel 1, ``rnn.scan_layer`` over a precomputed ax); logs each
    B's per-step slope and intercept of each, and the bounds at the
    largest T. Returns {B: {T: (scan ms, x-product ms, GRU scan ms)}}."""
    from sse_tpu_torch.ops import rnn

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    E = H = 128
    wx, wh, b = layer_weights(E, H, 4, gen)
    wh3 = layer_weights(E, H, 3, gen)[1]
    parts = {"rnn_scan_kernel": "scan", "gates_product_kernel": "x-product"}
    out = {}
    for B in Bs:
        xs_all = torch.randn((max(Ts), B, E), generator=gen, device="cuda").bfloat16()
        ax3_all = torch.randn((max(Ts), B, 3 * H), generator=gen, device="cuda")
        mask_all = ragged_mask(max(Ts), B, gen)
        out[B] = {}
        for T in Ts:
            xs, ax3 = xs_all[:T].contiguous(), ax3_all[:T].contiguous()
            mask = mask_all[:T].contiguous()
            run = lambda: rnn.rnn_layer(xs, mask, wx, wh, b, "lstm")  # noqa: E731
            split = parts_ms(run, parts)
            gru = kernel_ms(lambda: rnn.scan_layer(ax3, mask, wh3, "gru"), "rnn_scan_kernel")
            out[B][T] = (split["scan"], split["x-product"], gru)
        ys, fin = run()
        ops = 2.0 * T * B * (E + H) * 4 * H
        bnd = bound(nbytes(xs, mask, wx, wh, b, ys, ys, fin), ops)
        scan_bnd = bound(T * B * 4 * H * 4 + nbytes(mask, ys, ys, fin), 2.0 * T * B * H * 4 * H)
        log(slope_line(f"lstm_fwd B={B} E=H={H} scan", {t: v[0] for t, v in out[B].items()})
            + "; " + slope_line("x-product", {t: v[1] for t, v in out[B].items()})
            + "; " + slope_line("GRU-cell scan", {t: v[2] for t, v in out[B].items()})
            + f"; layer bound at T={T} {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), the "
            f"scan's with its ax round trip {scan_bnd['bound_ms']:.4f} ms, the x-product's "
            f"{product_bounds(T, B, E, H, 4, fwd=True)['x-product']:.4f} ms (bytes) [{card}]")
    return out


def rnn_bwd_costs(card: str, cell: str, Bs=(8, 256, 384, 2304, 4096), Ts=(1, 2, 50)) -> dict:
    """The GRU or LSTM layer backward (``rnn.{gru,lstm}_bwd_launch``,
    E=H=128, full lengths) at each (B, T): whole backward (CUDA events),
    its kernels' device time and its dh loop kernel alone (torch.profiler,
    bwd_split); logs each B's slopes and the bound at the largest T.
    Returns {B: {T: (ms, dh ms, kernels ms)}}."""
    from sse_tpu_torch.ops import rnn

    lstm = cell == "lstm"
    G = 4 if lstm else 3
    gen = torch.Generator(device="cuda").manual_seed(SEED + (12 if lstm else 10))
    E = H = 128
    wx, wh, b = layer_weights(E, H, G, gen)
    out = {}
    for B in Bs:
        out[B] = {}
        for T in Ts:
            xs = torch.randn((T, B, E), generator=gen, device="cuda").bfloat16()
            mask = torch.ones((T, 1, B), device="cuda")
            if lstm:
                ys, _, cs, _ = rnn.lstm_fwd_launch(xs, mask, wx, wh, b)
            else:
                (ys, _), cs = rnn.rnn_layer(xs, mask, wx, wh, b), None
            dys = (torch.randn((T, B, H), generator=gen, device="cuda") * 0.1).bfloat16()
            dfin = torch.randn((B, H), generator=gen, device="cuda")
            args = (xs, ys, mask, wx, wh, b, dys, dfin)
            run = ((lambda: rnn.lstm_bwd_launch(xs, ys, cs, *args[2:])) if lstm  # noqa: E731
                   else (lambda: rnn.gru_bwd_launch(*args)))
            split = bwd_split(run, cell)
            out[B][T] = (cuda_ms(run, reps=20), split["dh_loop"], sum(split.values()))
        parts = beside_bounds(split, product_bounds(T, B, E, H, G))
        bnd = bound(nbytes(*args, *([cs] if lstm else []), *run()[:4]),
                    2.0 * T * B * G * H * 3 * (E + H))
        log(slope_line(f"{cell}_bwd B={B} E=H={H}", {t: v[0] for t, v in out[B].items()})
            + f"; its kernels' device time at T={T} {out[B][T][2]:.4f} ms, of it the dh loop: "
            + slope_line("dh", {t: v[1] for t, v in out[B].items()})
            + f"; bound at T={T} {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); by kernel "
            + ", ".join(f"{k} {v['ms']:.4f}" + (f" (bytes bound {v['bound_ms']:.4f})"
                                                 if "bound_ms" in v else "")
                        for k, v in parts.items())
            + f" [{card}]")
    return out


# ------------------------------------------------------------ phase 2
def ptxas_report(log_text: str, pattern: str) -> list:
    """nvcc's -Xptxas -v report of each kernel whose (mangled) name holds
    ``pattern``: registers, stack and spill bytes, one line each."""
    out, name = [], None
    for line in log_text.splitlines():
        if "Compiling entry function '" in line:
            name = line.split("'")[1]
            out.append([name, ""])
        elif name and pattern in name and ("spill" in line or "Used " in line):
            out[-1][1] += " " + line.split(":", 1)[-1].strip()
    return [f"{n}:{r}" for n, r in out if pattern in n]


def check_products_ptxas(log_text: str) -> None:
    """Log every ptxas C7515 (wgmma serialized) line, and fail if one names
    a kernel of the product engine or if one of those spills; fail too if
    a cluster dh loop's instance spills (its threads a block,
    dh_cluster.cuh kThreadsMost, are set where none does)."""
    for line in log_text.splitlines():
        if "C7515" in line:
            log(f"ptxas: {line.strip()}")
            check("product_kernel" not in line, f"a product kernel's wgmma is serialized: {line}")
    for pattern in ("product_kernel", "bwd_dh_cluster_kernel"):
        for line in ptxas_report(log_text, pattern):
            check(" 0 bytes spill stores, 0 bytes spill loads" in line, f"a kernel spills: {line}")


def check_gru(card: str, results: dict) -> None:
    """The GRU layer forward against its plain version at T=50, E=H=128,
    B = 8 and 4096 (the served tiers), 256 and 384 (the train bench's
    source and target towers) (hold_layer); then its per-step cost
    (gru_fwd_costs)."""
    from sse_tpu_torch.ops import rnn

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    T, E, H = 50, 128, 128
    wx, wh, b = layer_weights(E, H, 3, gen)
    err = 0.0
    for B in (8, 256, 384, 4096):
        xs = torch.randn((T, B, E), generator=gen, device="cuda").bfloat16()
        args = (xs, ragged_mask(T, B, gen), wx, wh, b)
        ys, fin = rnn.rnn_layer(*args)
        torch.cuda.synchronize()
        e, e_ys, flips = hold_layer(f"gru_fwd B={B}", (ys, fin), rnn.rnn_layer_reference(*args))
        err = max(err, e, e_ys)
        ms = cuda_ms(lambda: rnn.rnn_layer(*args))
        dev = kernel_ms(lambda: rnn.rnn_layer(*args), "gru_fwd_kernel")
        plain = cuda_ms(lambda: rnn.rnn_layer_reference(*args), reps=3)
        log(f"gru_fwd T={T} B={B} E=H={H}: fin max_abs_err {e:.3g} (atol 2e-3, rtol 1e-3), "
            f"{flips} of {ys.numel()} bf16 ys values differ (max {e_ys:.3g}, one ulp); "
            f"kernel {ms:.4f} ms (its device time {dev:.4f}), plain {plain:.4f} ms [{card}]")
        if B == 4096:
            results["gru_fwd"].update(
                ms=ms, device_ms=dev, plain_ms=plain, library_ms=None,
                **bound(nbytes(*args, ys, fin), 2.0 * T * B * (E + H) * 3 * H))
    results["gru_fwd"]["max_abs_err"] = err
    gru_fwd_costs(card)


def check_lstm(card: str, results: dict) -> None:
    """The LSTM layer forward (x-product, then the scan) against its
    plain version at T=50, E=H=128, B = 8, 256 and 4096: ys, fin and cs
    (hold_layer), and the x-product it hands the scan to 1e-5 of its
    max-abs (fp32 sums of the same bf16 products in another order)."""
    from sse_tpu_torch.ops import rnn

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    T, E, H = 50, 128, 128
    wx, wh, b = layer_weights(E, H, 4, gen)
    err = 0.0
    for B in (8, 256, 4096):
        xs = torch.randn((T, B, E), generator=gen, device="cuda").bfloat16()
        mask = ragged_mask(T, B, gen)
        args = (xs, mask, wx, wh, b)
        ys, fin, cs, ax = rnn.lstm_fwd_launch(*args)
        torch.cuda.synchronize()
        e, e_b, flips = hold_layer(f"lstm_fwd B={B}", (ys, fin, cs),
                                   rnn.rnn_layer_reference(*args, "lstm"))
        ax_r = rnn._x_product(xs, wx, b)
        e_ax = float((ax - ax_r).abs().max()) / float(ax_r.abs().max())
        check(e_ax <= 1e-5, f"lstm_fwd B={B}: x-product {e_ax:.3g} of max-abs (bound 1e-5)")
        err = max(err, e, e_b)
        ms = cuda_ms(lambda: rnn.rnn_layer(*args, cell="lstm"))
        dev = parts_ms(lambda: rnn.rnn_layer(*args, cell="lstm"),
                       {"rnn_scan_kernel": "scan", "gates_product_kernel": "x-product"})
        plain = cuda_ms(lambda: rnn.rnn_layer_reference(*args, "lstm"), reps=3)
        lstm = cudnn_lstm(wx, wh, b)
        with torch.no_grad():
            lib = cuda_ms(lambda: lstm(xs))
        log(f"lstm_fwd T={T} B={B} E=H={H}: fin max_abs_err {e:.3g} (atol 2e-3, rtol 1e-3), "
            f"{flips} of {2 * ys.numel()} bf16 ys/cs values differ (max {e_b:.3g}, one ulp), "
            f"x-product {e_ax:.2g} of max-abs; kernel {ms:.4f} ms (its device time "
            f"{sum(dev.values()):.4f}: scan {dev['scan']:.4f}, x-product {dev['x-product']:.4f}), "
            f"plain {plain:.4f} ms, cuDNN LSTM (full lengths) {lib:.4f} ms [{card}]")
        if B == 4096:
            results["lstm_fwd"].update(
                ms=ms, device_ms=sum(dev.values()), plain_ms=plain, library_ms=lib,
                cuda_kernels=beside_bounds(dev, product_bounds(T, B, E, H, 4, fwd=True)),
                **bound(nbytes(*args, ys, cs, fin), 2.0 * T * B * (E + H) * 4 * H))
    results["lstm_fwd"]["max_abs_err"] = err
    lstm_fwd_costs(card)


def check_scan(card: str, results: dict) -> None:
    """The scan over precomputed pre-activations (kernel 1), GRU and LSTM,
    at T=50, H=128, B=4096, against its plain version (hold_layer)."""
    from sse_tpu_torch.ops import rnn

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    T, B, H = 50, 4096, 128
    err = 0.0
    for cell, G in (("gru", 3), ("lstm", 4)):
        ax = torch.randn((T, B, G * H), generator=gen, device="cuda")
        wh = (torch.randn((H, G * H), generator=gen, device="cuda") * 0.08).bfloat16()
        mask = ragged_mask(T, B, gen)
        ys, fin = rnn.scan_layer(ax, mask, wh, cell)
        torch.cuda.synchronize()
        e, e_b, flips = hold_layer(f"rnn_scan {cell}", (ys, fin),
                                   rnn.scan_layer_reference(ax, mask, wh, cell))
        err = max(err, e, e_b)
        ms = cuda_ms(lambda: rnn.scan_layer(ax, mask, wh, cell))
        dev = kernel_ms(lambda: rnn.scan_layer(ax, mask, wh, cell), "rnn_scan_kernel")
        plain = cuda_ms(lambda: rnn.scan_layer_reference(ax, mask, wh, cell), reps=3)
        bnd = bound(nbytes(ax, mask, wh, ys, fin), 2.0 * T * B * H * G * H)
        log(f"rnn_scan {cell} T={T} B={B} H={H}: fin max_abs_err {e:.3g}, {flips} of "
            f"{ys.numel()} bf16 ys values differ (max {e_b:.3g}, one ulp); kernel {ms:.4f} ms "
            f"(its device time {dev:.4f}), plain {plain:.4f} ms; bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']}) [{card}]")
        if cell == "lstm":
            results["rnn_scan"].update(ms=ms, device_ms=dev, plain_ms=plain, library_ms=None,
                                       **bnd)
    results["rnn_scan"]["max_abs_err"] = err


def bf16_order(x: torch.Tensor) -> torch.Tensor:
    """bf16 values as integers in the order of the values: adjacent bf16
    values differ by 1 (+0 and -0 both map to 0)."""
    i = x.contiguous().view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


def held_to_one_ulp(name: str, got: torch.Tensor, want: torch.Tensor) -> str:
    """bf16 ``got`` against ``want``: every element within one bf16 ulp
    plus 1e-6 of want's max-abs (the slack of a value that cancels to
    near zero, whose fp32 sums in another order differ by many of its
    own ulps), and at most 1e-3 of the elements differ at all."""
    g, w = got.float(), want.float()
    slack = 1e-6 * float(w.abs().max())
    torch.testing.assert_close(g, w, atol=slack, rtol=2.0**-7, msg=lambda m: f"{name}: {m}")
    ulps = (bf16_order(got) - bf16_order(want)).abs()
    share = float((ulps > 0).float().mean())
    check(share <= 1e-3, f"{name}: {share:.3g} of the values differ (bound 1e-3)")
    return f"{name} {share:.3g} differ (max {int(ulps.max())} ulp)"


def check_bwd(card: str, results: dict, cell: str) -> None:
    """The GRU or LSTM backward kernels against the plain version, at the
    main path's shapes (T=50, E=H=128: B=128 and 2,304, the ranking and
    qna presets' source and target towers; B=256 and 384, the train
    bench's) and two short ones (T=1, B=1; T=3, B=33). The forward that
    feeds them is the kernel's (ys, and the LSTM's bf16 cs).

    End to end (rnn_layer_bwd against rnn_layer_bwd_reference): dWx, dWh
    and db to at most 1e-3 of each tensor's max-abs; dxs to one bf16 ulp
    plus 1e-4 of its max-abs at every step when T <= 3, at the reverse
    loop's first step (t = T-1) at T=50, and to 1e-2 of its max-abs over
    all T=50 steps. The looser bound at T=50 is the chain's: both
    versions round dgates to bf16 at every step from fp32 sums taken in
    another order, a value at a rounding edge goes the other way, and the
    dh (and the LSTM's dc) chain carries that difference to every earlier
    step.

    Rounding points, at T=50 (the *_bwd_launch wrappers also return the
    kernels' gates and dgates_b): the plain version's gate recompute
    against the kernel's gates to 1e-5 of max-abs; the plain chain, fed
    the kernel's gates and driven by its dgates_b (the chain's ``drive``),
    against the kernel's dgates_b, and bf16(dgates_b·Wxᵀ) of the kernel's
    dgates_b against its dxs, each held_to_one_ulp; xsᵀ·dgates_b,
    h_prevᵀ·dgates_b and the chain's db against the kernel's to 1e-5 of
    max-abs. Without the chain's drift these hold where the end-to-end
    bounds cannot: a version that fed fp32 dgates to the dh, dxs or dW
    product, or summed bf16 dgates into db, misses them about 100-fold,
    while the end-to-end bounds let the dh and db cases through."""
    from sse_tpu_torch.ops import rnn

    lstm = cell == "lstm"
    G, name = (4 if lstm else 3), f"{cell}_bwd"
    report_b = 256 if lstm else 384
    gen = torch.Generator(device="cuda").manual_seed(SEED + (7 if lstm else 3))
    E = H = 128
    worst = {"dxs": 0.0, "dwx": 0.0, "dwh": 0.0, "db": 0.0}
    pinned = {}
    err = 0.0
    for T, B in ((1, 1), (3, 33), (50, 128), (50, 256), (50, 384), (50, 2304)):
        wx, wh, b = layer_weights(E, H, G, gen)
        xs = torch.randn((T, B, E), generator=gen, device="cuda").bfloat16()
        mask = ragged_mask(T, B, gen)
        if lstm:
            ys, _, cs, _ = rnn.lstm_fwd_launch(xs, mask, wx, wh, b)
        else:
            (ys, _), cs = rnn.rnn_layer(xs, mask, wx, wh, b), None
        dys = (torch.randn((T, B, H), generator=gen, device="cuda") * 0.1).bfloat16()
        dfin = torch.randn((B, H), generator=gen, device="cuda")
        args = (xs, ys, mask, wx, wh, b, dys, dfin)
        out = rnn.lstm_bwd_launch(xs, ys, cs, *args[2:]) if lstm else rnn.gru_bwd_launch(*args)
        torch.cuda.synchronize()
        got, (gates, dgb) = out[:4], out[4:]
        want = rnn.rnn_layer_bwd_reference(*args, cs, cell)
        gx, wx_ = got[0].float(), want[0].float()
        ulp = dict(atol=1e-4 * float(wx_.abs().max()), rtol=2.0**-7)
        if T <= 3:
            torch.testing.assert_close(gx, wx_, **ulp)
        else:
            torch.testing.assert_close(gx[-1], wx_[-1], **ulp)
        line = []
        for part, g, w in zip(("dxs", "dwx", "dwh", "db"), got, want):
            e = float((g.float() - w.float()).abs().max())
            rel = e / max(float(w.float().abs().max()), 1e-30)
            check(rel <= (1e-2 if part == "dxs" else 1e-3),
                  f"{name} T={T} B={B} {part}: max_abs_err {e} is {rel:.3g} of max-abs")
            worst[part] = max(worst[part], rel)
            err = max(err, e)
            line.append(f"{part} {e:.3g} ({rel:.2g} of max-abs)")
        msg = f"{name} T={T} B={B} E=H={H}: " + ", ".join(line)
        if T == 50:
            h_prev = rnn._h_prev(ys)
            if lstm:
                dgb_r, db_r = rnn.lstm_bwd_chain(gates, rnn._h_prev(cs), mask, wh, dys, dfin,
                                                 drive=dgb)
            else:
                dgb_r, db_r = rnn.gru_bwd_chain(gates, h_prev, mask, wh, dys, dfin, drive=dgb)
            dxs_r, dwx_r, dwh_r = rnn.bwd_products(xs, h_prev, wx, dgb)
            rels = {}
            for part, g, w in (("gates", gates, rnn.layer_gates(xs, h_prev, wx, wh, b)),
                               ("dwx", got[1], dwx_r), ("dwh", got[2], dwh_r), ("db", got[3], db_r)):
                rels[part] = float((g - w).abs().max()) / float(w.abs().max())
                check(rels[part] <= 1e-5,
                      f"{name} T={T} B={B} pinned {part}: {rels[part]:.3g} of max-abs (bound 1e-5)")
                pinned[part] = max(pinned.get(part, 0.0), rels[part])
            msg += ("; pinned: " + held_to_one_ulp(f"dgates_b B={B}", dgb_r, dgb) + ", "
                    + held_to_one_ulp(f"dxs B={B}", got[0], dxs_r) + ", "
                    + ", ".join(f"{k} {v:.2g} of max-abs" for k, v in rels.items()))
            run = lambda: rnn.rnn_layer_bwd(*args, cs=cs, cell=cell)  # noqa: E731
            ms = cuda_ms(run)
            plain = cuda_ms(lambda: rnn.rnn_layer_bwd_reference(*args, cs, cell), reps=2)
            msg += f"; kernel {ms:.4f} ms, plain {plain:.4f} ms"
            split = bwd_split(run, cell) if B == report_b else None
            lib = None
            if lstm:
                lstm_mod = cudnn_lstm(wx, wh, b)
                x_l = xs.clone().requires_grad_(True)
                y_l, _ = lstm_mod(x_l)
                inputs = [x_l, *lstm_mod.parameters()]
                lib = cuda_ms(lambda: torch.autograd.grad(y_l, inputs, dys, retain_graph=True))
                msg += f", cuDNN LSTM backward (full lengths) {lib:.4f} ms"
            if B == report_b:
                ops = 2.0 * T * B * G * H * 3 * (E + H)
                moved = nbytes(*args, *([cs] if lstm else []), *got)
                results[name].update(ms=ms, plain_ms=plain, library_ms=lib,
                                     cuda_kernels=beside_bounds(split,
                                                                product_bounds(T, B, E, H, G)),
                                     **bound(moved, ops))
        log(msg + f" [{card}]")
    results[name].update(max_abs_err=err, rel_err=worst, pinned_rel_err=pinned)
    log(f"{name} kernels at T=50, B={report_b} (torch.profiler, ms per backward): "
        f"{json.dumps(results[name]['cuda_kernels'])}")


def bwd_kernels(cell: str) -> dict:
    """CUDA kernel of a layer backward (csrc/{gru,lstm}_bwd.cu and the
    product engine it launches, csrc/products.cu) → what it computes."""
    return {
        "gates_product_kernel": "gates",
        f"{cell}_bwd_dh_": "dh_loop",  # the single-block and the cluster instances
        "dxs_product_kernel": "dxs",
        "dw_product_kernel": "dw",
        "bwd_reduce_kernel": "reduce",
    }


def product_bounds(T: int, B: int, E: int, H: int, G: int, fwd: bool = False) -> dict:
    """The byte bound (ms) of each product of the engine (csrc/products.cu)
    at these shapes: each input read once and each output written once at
    the HBM rate. Every one is bound by bytes (2·K operations for each 2-
    or 4-byte output, K = E+H or G·H <= 768 here, under the ~295
    operations a byte where the tensor cores would limit). ``fwd``: the
    LSTM forward's x-product alone, else the backward's gates, dxs and dW
    (to the summed dW; the partials are the engine's own traffic)."""
    M, N = T * B, G * H
    if fwd:
        moved = {"x-product": M * E * 2 + N * E * 2 + N * 4 + M * N * 4}
    else:
        moved = {"gates": M * (E + H) * 2 + N * (E + H) * 2 + N * 4 + M * N * 4,
                 "dxs": M * N * 2 + E * N * 2 + M * E * 2,
                 "dw": M * (E + H + N) * 2 + (E + H) * N * 4}
    return {k: v / PEAK["bytes"] * 1e3 for k, v in moved.items()}


def beside_bounds(split: dict, bounds: dict) -> dict:
    """{part: {"ms": device ms, "bound_ms": its byte bound}} (the bound
    where the part is a product of the engine)."""
    return {k: {"ms": v, **({"bound_ms": bounds[k]} if k in bounds else {})}
            for k, v in split.items()}


def device_times(prof, counts: dict | None = None) -> dict:
    """Name → total device ms of each event on the device timeline of a
    torch.profiler run (kernels, copies, and the spans of profiler ranges;
    CPU ops, which also report the device time of what they launched,
    are left out so nothing counts twice). ``counts``, where given, gets
    name → number of events."""
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        if t > 0:
            out[ev.key] = out.get(ev.key, 0.0) + t / 1000.0
            if counts is not None:
                counts[ev.key] = counts.get(ev.key, 0) + ev.count
    return out


def warn(msg: str) -> None:
    """log(msg), and the same line on stderr."""
    log(msg)
    print(msg, file=sys.stderr, flush=True)


def profiled(run, reps: int, want=(), tries: int = 4) -> dict | None:
    """device_times of one torch.profiler session over ``reps`` runs of
    ``run()``, or None where the profiler lost the records it needed.

    Now and then torch.profiler drops kernel records on the H100: one
    backward's session came back with only the last of its 25 launches,
    and in one run three sessions in a row kept only a backward's last
    kernel. So a session in which a name pattern of ``want`` matched
    fewer than ``reps`` events is profiled again after a warm run, from
    the second session on with the CPU activity as well (the profiler's
    other path), up to ``tries`` sessions. If every session lost them,
    the reading is not measured: warn names what was lost, and the
    caller reports NOT_MEASURED. No check of a kernel reads the profiler:
    its results are held against its plain version and its launches are
    counted by its wrapper, so a lost record costs a split, never a
    check."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, tries + 1):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
        counts = {}
        times = device_times(prof, counts)
        short = {p: sum(c for k, c in counts.items() if p in k) for p in want}
        short = {p: c for p, c in short.items() if c < reps}
        if not short:
            return times
        warn(f"torch.profiler session {attempt} of {tries} saw too few events of {short} "
             f"(want {reps} each): {json.dumps(counts)}")
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        run()
        torch.cuda.synchronize()
    warn(f"torch.profiler lost the events of {sorted(short)} in {tries} sessions: "
         f"this reading is not measured")
    return None


def bwd_split(run, cell: str, reps: int = 5) -> dict:
    """Device ms of each CUDA kernel of one backward (``run()``), from
    torch.profiler."""
    kernels = bwd_kernels(cell)
    times = profiled(run, reps, want=tuple(kernels))
    if times is None:
        return dict.fromkeys(kernels.values(), NOT_MEASURED)
    split = {}
    for key, ms in times.items():
        for pat, part in kernels.items():
            if pat in key:
                split[part] = split.get(part, 0.0) + ms / reps
    check(set(split) == set(kernels.values()), f"{cell}_bwd kernels seen: {split}")
    return split


def twophase_data(dtype: str, gen, b: int = 4096):
    """The two-phase checks' index and queries: exact-dot bf16 rows (every
    float32 sum exact, in any order) or int8 unit rows (exact integer
    sums) with 127-quantized unit queries."""
    from sse_tpu_torch.index.sharded_index import quantize_rows
    from sse_tpu_torch.ops import topk

    if dtype == "bf16":
        return exact_dot((T_PAD, D), gen), exact_dot((b, D), gen)
    return (quantize_rows(unit_rows(T_PAD, gen), torch.int8),
            topk.quantize_queries_int8(unit_rows(b, gen)))


# kernel-name patterns of the two-phase call's parts on the device timeline
TWOPHASE_PARTS = {"blockmax_kernel": "phase 1", "topk_select_kernel": "select",
                  "pairs_kernel": "phase 2"}


def twophase_split(q, emb, nr: int, bt: int, reps: int = 5) -> dict:
    """Device ms of one fused_score_topk_twophase call by part
    (torch.profiler): phase 1, its select (mode 0), the mid-pass
    (pair_schedule, profiled alone), phase 2, and the merge (the rest of
    the call's device time); "call" is the sum."""
    from sse_tpu_torch.ops import topk

    def parts(run, want=()) -> dict:
        run()
        torch.cuda.synchronize()
        times = profiled(run, reps, want)
        if times is None:
            return dict.fromkeys([*TWOPHASE_PARTS.values(), "rest"], NOT_MEASURED)
        out = {}
        for key, ms in times.items():
            part = next((p for pat, p in TWOPHASE_PARTS.items() if pat in key), "rest")
            out[part] = out.get(part, 0.0) + ms / reps
        return out

    split = parts(lambda: topk.fused_score_topk_twophase(q, emb, K, nr, block_t=bt),
                  want=tuple(TWOPHASE_PARTS))
    p1 = topk.twophase_phase1(q, emb, K, nr, bt)
    mid = sum(parts(lambda: topk.pair_schedule(p1, emb.shape[0] // bt)).values())
    rest = split.pop("rest", 0.0)
    split.update({"mid-pass": mid, "merge": rest - mid})
    split["call"] = sum(split.values())
    return split


def fmt(split: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in split.items())


def twophase_costs(card: str) -> None:
    """The two-phase route's device time at B=4096 by part (bf16 and
    int8), cuBLAS's bf16 product alone as phase 1's yardstick, the route
    against streaming at B = 256 to 4096 (the crossover), and one
    engine bulk query at B=4096 with its GRU encode, split by kernel.
    Uses only the package's public two-phase functions, so a copy of this
    file in an older checkout measures that checkout."""
    from sse_tpu_torch.ops import topk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    nr = T_PAD - 1000
    bt = topk.twophase_block_t(T_PAD, K)
    for dtype in ("bf16", "int8"):
        emb, q = twophase_data(dtype, gen)
        log(f"twophase {dtype} B=4096 device ms by part: {fmt(twophase_split(q, emb, nr, bt))} "
            f"[{card}]")
        if dtype == "bf16":
            # the product alone, in chunks of rows: no block max, no index
            out = torch.empty((q.shape[0], T_PAD // 20), dtype=torch.bfloat16, device="cuda")
            chunks = [emb[i : i + out.shape[1]] for i in range(0, T_PAD, out.shape[1])]
            ms = cuda_ms(lambda: [torch.matmul(q, e.T, out=out) for e in chunks], reps=3)
            log(f"yardstick: cuBLAS bf16 q @ emb.T at B=4096 over {T_PAD} rows in "
                f"{len(chunks)} chunks, {ms:.4f} ms, {2.0 * q.shape[0] * T_PAD * D / ms / 1e9:.1f} "
                f"TFLOP/s [{card}]")
            del out, chunks
        times = []
        for b in (256, 512, 1024, 2048, 4096):
            qb = q[:b].contiguous()
            tp = kernel_ms(lambda: topk.fused_score_topk_twophase(qb, emb, K, nr, block_t=bt), "",
                           reps=3)
            st = kernel_ms(lambda: topk.fused_score_topk(qb, emb, K, nr), "", reps=3)
            times.append(f"B={b} two-phase {tp:.4f} / streaming {st:.4f}")
        log(f"crossover {dtype} (device ms a call): " + "; ".join(times) + f" [{card}]")
        del emb, q
        torch.cuda.empty_cache()
    log(f"engine bulk query B=4096 (GRU encode + two-phase top-k), device ms by kernel: "
        f"{fmt(engine_split(4096))} [{card}]")


def engine_split(b: int, reps: int = 3) -> dict:
    """Device ms of one batch of the served GRU model (the bench model,
    random weights from the seed) at B=b, L=50, through
    build_fused_query_fn on the 1,249,280-row bf16 index of unit rows,
    split by kernel: B=8 streams (a served interactive query), B=4096
    takes the two-phase route (a bulk batch)."""
    from sse_tpu_torch.models import sse
    from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
    from sse_tpu_torch.models.towers import TowerConfig
    from sse_tpu_torch.serve.engine import build_fused_query_fn

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    width = dict(vocab_size=8000, embed_dim=128, hidden=128, num_layers=1, encoding_dim=128)
    cfg = SSEConfig(mode=NetworkMode.SHARED_ENCODER, src_tower=TowerConfig(cell="gru", **width))
    params = sse.init_params(cfg, torch.Generator().manual_seed(SEED))
    emb = unit_rows(T_PAD, gen).bfloat16()
    tokens = torch.randint(1, 8000, (b, 50), generator=gen, device="cuda")
    lengths = torch.randint(1, 51, (b,), generator=gen, device="cuda")
    fused = build_fused_query_fn(cfg, K)
    run = lambda: fused(params, emb, tokens, lengths, T_PAD - 1000)  # noqa: E731
    run()
    torch.cuda.synchronize()
    pats = {"gru_fwd": "GRU", **TWOPHASE_PARTS, **STREAM_PARTS}
    times = profiled(run, reps, want=("gru_fwd",))
    if times is None:
        return {"batch": NOT_MEASURED}
    out = {}
    for key, ms in times.items():
        part = next((p for pat, p in pats.items() if pat in key), "other")
        out[part] = out.get(part, 0.0) + ms / reps
    out["batch"] = sum(out.values())
    return out


# kernel-name patterns of a streaming call's parts (select first: the
# streaming kernel's name is the one holding "stream")
STREAM_PARTS = {"topk_select_kernel": "select", "stream": "streaming"}
STREAM_BATCHES = (1, 8, 64, 256, 1024, 4096)


def stream_split(run, reps: int = 3) -> tuple:
    """Device ms of one streaming call (``run()``) by part, from
    torch.profiler after a warm call: the streaming kernel, the select,
    and the rest; and the names of the streaming kernels seen."""
    run()
    torch.cuda.synchronize()
    times = profiled(run, reps, want=("stream",))
    if times is None:
        return {"streaming": NOT_MEASURED, "select": NOT_MEASURED}, set()
    out, names = {"streaming": 0.0, "select": 0.0}, set()
    for key, ms in times.items():
        part = next((p for pat, p in STREAM_PARTS.items() if pat in key), "rest")
        if part == "streaming":
            names.add(key.split("<")[0])
        out[part] = out.get(part, 0.0) + ms / reps
    return out, names


def stream_costs(card: str) -> None:
    """The streaming top-k (both variants, bf16 and int8, random unit rows
    on the 1,249,280-row index, num_real = T_pad - 1000) at B in
    STREAM_BATCHES and k in {10, 100}: device ms of the kernel and of the
    select, the bound, and at B >= 64 the packed two-phase call beside it
    (the crossover); cuBLAS's product alone at B=256 and 4096 as a
    yardstick (no single PyTorch call computes a top-k without the [B, T]
    matrix); a served B=8 GRU query's device time by kernel. Uses only the
    package's public functions, so a copy of this file in an older
    checkout measures that checkout."""
    from sse_tpu_torch.index.sharded_index import quantize_rows
    from sse_tpu_torch.ops import topk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    nr = T_PAD - 1000
    bt = topk.twophase_block_t(T_PAD, K)
    seen = set()
    for dtype in ("bf16", "int8"):
        if dtype == "bf16":
            emb, q_all = unit_rows(T_PAD, gen).bfloat16(), unit_rows(4096, gen).bfloat16()
        else:
            emb = quantize_rows(unit_rows(T_PAD, gen), torch.int8)
            q_all = topk.quantize_queries_int8(unit_rows(4096, gen))
        for variant in ("packed", "exact"):
            for k in (10, 100):
                cells = []
                for b in STREAM_BATCHES:
                    q = q_all[:b].contiguous()
                    split, names = stream_split(
                        lambda: topk.fused_score_topk(q, emb, k, nr, variant=variant))
                    seen |= names
                    bnd = bound(nbytes(q, emb) + 8 * b * k, 2.0 * b * nr * D, dtype)
                    cell = (f"B={b} kernel {split['streaming']:.4f} + select {split['select']:.4f}"
                            f" (bound {bnd['bound_ms']:.4f} by {bnd['bound_by']}")
                    if variant == "packed" and b >= 64:
                        tp = kernel_ms(
                            lambda: topk.fused_score_topk_twophase(q, emb, k, nr, block_t=bt), "",
                            reps=3)
                        cell += f"; two-phase {tp:.4f}"
                    cells.append(cell + ")")
                log(f"stream {variant} {dtype} k={k}, device ms a call: " + "; ".join(cells)
                    + f" [{card}]")
        if dtype == "bf16":
            out = torch.empty((4096, T_PAD // 20), dtype=torch.bfloat16, device="cuda")
            chunks = [emb[i : i + out.shape[1]] for i in range(0, T_PAD, out.shape[1])]
            for b in (256, 4096):
                q, o = q_all[:b], out[:b]
                ms = cuda_ms(lambda: [torch.matmul(q, e.T, out=o) for e in chunks], reps=3)
                log(f"yardstick (not a library row): cuBLAS bf16 q @ emb.T alone at B={b} over "
                    f"{T_PAD} rows in {len(chunks)} chunks, {ms:.4f} ms, "
                    f"{2.0 * b * T_PAD * D / ms / 1e9:.1f} TFLOP/s [{card}]")
            del out, chunks
        del emb, q_all
        torch.cuda.empty_cache()
    log(f"streaming kernels seen by torch.profiler: {sorted(seen)}")
    log(f"served GRU query B=8 (GRU encode + streaming top-k), device ms by kernel: "
        f"{fmt(engine_split(8))} [{card}]")


def hold_phases(name: str, q, emb, nr: int, bt: int) -> None:
    """Phase 1 and phase 2 kernels bit-identical to their plain versions."""
    from sse_tpu_torch.ops import topk

    p1 = topk.twophase_phase1(q, emb, K, nr, bt)
    check(torch.equal(p1, topk.twophase_phase1_reference(q, emb, K, nr, bt)),
          f"{name}: phase 1 block keys differ")
    tq, tb, _ = topk.pair_schedule(p1, emb.shape[0] // bt)
    check(torch.equal(topk.twophase_phase2(q, emb, K, nr, bt, tq, tb),
                      topk.twophase_phase2_reference(q, emb, K, nr, bt, tq, tb)),
          f"{name}: phase 2 pair candidates differ")


STREAM_EDGES = (0, 5, 127, 128, 129, 4095, 4096, 4097)  # num_real: none, < k, tile and window edges


def hold_stream_edges(name: str, q_all, emb, variant: str) -> None:
    """The streaming call bit-identical to plain at the num_real edges
    (B=8; sinks: packed finite below -1e37, exact exactly float32(-3e38),
    row 0), with a zero query row (and a -0.0 one for bf16: rows 0..k-1,
    value +0.0), and at B=8 and 256 under
    torch.cuda.set_sync_debug_mode("error")."""
    from sse_tpu_torch.ops import topk

    q = q_all[:8].contiguous()
    for edge_nr in STREAM_EDGES:
        v, rows = topk.fused_score_topk(q, emb, K, edge_nr, variant=variant)
        same(f"{name} num_real={edge_nr}", (v, rows),
             topk.topk_reference(q, emb, K, edge_nr, variant=variant))
        sink = v[:, edge_nr:]
        check(bool((sink == -3.0e38).all() if variant == "exact" else (sink < -1e37).all())
              and bool((rows[:, edge_nr:] == 0).all()), f"{name} num_real={edge_nr}: sinks")
    qz = q.clone()
    qz[1] = 0
    if emb.dtype == torch.bfloat16:
        qz[2] = -0.0
    v, rows = topk.fused_score_topk(qz, emb, K, T_PAD, variant=variant)
    same(f"{name} zero query rows", (v, rows), topk.topk_reference(qz, emb, K, T_PAD, variant=variant))
    for i in (1, 2) if emb.dtype == torch.bfloat16 else (1,):
        check(rows[i].tolist() == list(range(K)) and bool((v[i] == 0).all())
              and not bool(torch.signbit(v[i]).any()), f"{name}: a zero query row keys +0.0")
    for B in (8, 256):
        q = q_all[:B].contiguous()
        want = topk.fused_score_topk(q, emb, K, T_PAD - 1000, variant=variant)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = topk.fused_score_topk(q, emb, K, T_PAD - 1000, variant=variant)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        same(f"{name} B={B} under sync debug", got, want)


def check_topk(card: str, results: dict) -> None:
    from sse_tpu_torch.index.sharded_index import quantize_rows
    from sse_tpu_torch.ops import topk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    nr = T_PAD - 1000
    bt = topk.twophase_block_t(T_PAD, K)
    nblocks = T_PAD // bt
    for dtype in ("bf16", "int8"):
        emb, q_all = twophase_data(dtype, gen)

        # streaming at B = 8 (the served interactive batch: one warpgroup of
        # 64 query rows, 8 real) and at B = 256 (two groups of 128)
        for B in (8, 256):
            q = q_all[:B].contiguous()
            got = topk.fused_score_topk(q, emb, K, nr)
            want = topk.topk_reference(q, emb, K, nr)
            err = same(f"topk_stream {dtype} B={B}", got, want)
            ms = cuda_ms(lambda: topk.fused_score_topk(q, emb, K, nr))
            plain = cuda_ms(lambda: topk.topk_reference(q, emb, K, nr), reps=2)
            log(f"topk_stream {dtype} B={B} T={T_PAD} num_real={nr} k={K}: bit-identical "
                f"to plain; kernel {ms:.4f} ms, plain {plain:.4f} ms [{card}]")
            r = results["topk_stream"]
            r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
            if dtype == "bf16":
                at = dict(ms=ms, plain_ms=plain, **bound(nbytes(q, emb, *got), 2.0 * B * nr * D))
                r.setdefault("at_batch", {})[str(B)] = at
                if B == 8:
                    r.update(library_ms=None, **at)
        hold_stream_edges(f"topk_stream {dtype}", q_all, emb, "packed")
        log(f"topk_stream {dtype}: bit-identical to plain at num_real {STREAM_EDGES} (B=8; "
            f"finite sinks with row 0) and with zero query rows; B=8 and 256 ran under "
            f"torch.cuda.set_sync_debug_mode('error')")

        # two-phase, B = 4096: each phase against its plain version
        q = q_all
        p1 = topk.twophase_phase1(q, emb, K, nr, bt)
        p1_ref = topk.twophase_phase1_reference(q, emb, K, nr, bt)
        check(torch.equal(p1, p1_ref), f"twophase phase 1 {dtype}: block keys differ")
        tq, tb, pos = topk.pair_schedule(p1, nblocks)
        p2 = topk.twophase_phase2(q, emb, K, nr, bt, tq, tb)
        p2_ref = topk.twophase_phase2_reference(q, emb, K, nr, bt, tq, tb)
        check(torch.equal(p2, p2_ref), f"twophase phase 2 {dtype}: pair candidates differ")
        int_exact = dtype == "int8"
        for name, got_c, want_c in (("twophase_p1", p1, p1_ref), ("twophase_p2", p2, p2_ref)):
            dv = (topk.decode(got_c, int_exact)[0] - topk.decode(want_c, int_exact)[0]).abs()
            r = results[name]
            r["max_abs_err"] = max(r.get("max_abs_err", 0.0), float(dv.max()))
        ms1 = cuda_ms(lambda: topk.twophase_phase1(q, emb, K, nr, bt))
        plain1 = cuda_ms(lambda: topk.twophase_phase1_reference(q, emb, K, nr, bt), reps=1)
        ms2 = cuda_ms(lambda: topk.twophase_phase2(q, emb, K, nr, bt, tq, tb))
        plain2 = cuda_ms(lambda: topk.twophase_phase2_reference(q, emb, K, nr, bt, tq, tb), reps=1)
        full = topk.fused_score_topk_twophase(q, emb, K, nr, block_t=bt)
        ms_all = cuda_ms(lambda: topk.fused_score_topk_twophase(q, emb, K, nr, block_t=bt))
        stream = topk.fused_score_topk(q, emb, K, nr)
        ms_stream = cuda_ms(lambda: topk.fused_score_topk(q, emb, K, nr), reps=2)
        same(f"twophase == streaming {dtype} B=4096", full, stream)
        sub = slice(0, 512)  # the full [4096, T] reference would be 20 GB
        same(f"twophase {dtype} B=4096 (512-query subset)",
             (full[0][sub], full[1][sub]), topk.topk_reference(q[sub], emb, K, nr))
        log(f"twophase {dtype} B=4096 T={T_PAD} k={K} block_t={bt}: phases bit-identical "
            f"to plain, result == streaming == reference; phase1 {ms1:.4f} ms "
            f"(plain {plain1:.4f}), phase2 {ms2:.4f} ms (plain {plain2:.4f}), "
            f"whole two-phase {ms_all:.4f} ms, streaming at B=4096 {ms_stream:.4f} ms [{card}]")
        for small_nr in (0, 5):
            v, rows = topk.fused_score_topk_twophase(q[:1024], emb, K, small_nr, block_t=bt)
            same(f"twophase {dtype} num_real={small_nr}", (v, rows),
                 topk.topk_reference(q[:1024], emb, K, small_nr))
            check(torch.isfinite(v).all() and (v[:, small_nr:] < -1e37).all(),
                  f"twophase {dtype} num_real={small_nr}: sinks must be finite")

        # the edges: num_real at block and tile ends, a ragged last query
        # group (B=1500) and a lone query, a zero and a -0.0 query row
        qe = q.clone()
        qe[1] = 0
        if dtype == "bf16":
            qe[2] = -0.0
        for edge_nr in (0, 5, 2047, 2048, 2049, nr):
            hold_phases(f"twophase {dtype} B=4096 num_real={edge_nr}", qe, emb, edge_nr, bt)
        for b in (1, 1500):
            hold_phases(f"twophase {dtype} B={b}", qe[:b].contiguous(), emb, nr, bt)
        v, rows = topk.fused_score_topk_twophase(qe[:64], emb, K, nr, block_t=bt)
        same(f"twophase {dtype} zero query rows", (v, rows), topk.topk_reference(qe[:64], emb, K, nr))
        zero_rows = (1, 2) if dtype == "bf16" else (1,)
        for i in zero_rows:
            check(rows[i].tolist() == list(range(K)) and not bool(torch.signbit(v[i]).any())
                  and bool((v[i] == 0).all()), f"twophase {dtype}: a zero query row keys +0.0")
        log(f"twophase {dtype}: phases bit-identical to plain at num_real 0, 5, 2047, 2048, "
            f"2049, {nr} (B=4096), at B=1 and 1500, with "
            f"{'zero and -0.0 query rows' if dtype == 'bf16' else 'a zero query row'} "
            f"(rows 0..{K - 1}, value +0.0)")

        # no host sync anywhere in the call
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = topk.fused_score_topk_twophase(q, emb, K, nr, block_t=bt)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        same(f"twophase {dtype} under sync debug", got, full)
        log(f"twophase {dtype} B=4096: the whole call ran under "
            f"torch.cuda.set_sync_debug_mode('error')")
        # phase 2's work is this run's valid (query, block) pairs, each a
        # bt-row block against one query; it reads each block once
        tile_ok = (tb >= 0)[:, None] & (tq.view(tb.shape[0], -1) >= 0)
        pairs = int(tile_ok.sum())
        blocks = int(torch.unique(tb[tb >= 0]).numel())
        bound1 = bound(nbytes(q, emb, p1), 2.0 * q.shape[0] * nr * D, dtype)
        bound2 = bound(nbytes(q, tq, tb, p2) + blocks * bt * D * emb.element_size(),
                       2.0 * pairs * bt * D, dtype)
        if dtype == "bf16":
            results["twophase_p1"].update(ms=ms1, plain_ms=plain1, library_ms=None, **bound1)
            results["twophase_p2"].update(ms=ms2, plain_ms=plain2, library_ms=None, **bound2)
        else:
            log(f"twophase int8 B=4096: phase 1 {ms1:.4f} ms against its bound "
                f"{bound1['bound_ms']:.4f} ms ({bound1['bound_by']}), phase 2 {ms2:.4f} ms "
                f"against {bound2['bound_ms']:.4f} ms ({bound2['bound_by']}; {pairs} pairs, "
                f"{blocks} blocks) [{card}]")
        del emb, q_all, q, qe
        torch.cuda.empty_cache()

    # random unit rows (float32 sums not exact): both routes score through
    # the same wgmma tile, so no B=4096 query row may rank apart
    for dtype in ("bf16", "int8"):
        x, q = unit_rows(T_PAD, gen), unit_rows(4096, gen)
        emb = x.bfloat16() if dtype == "bf16" else quantize_rows(x, torch.int8)
        del x
        tp = topk.fused_score_topk_twophase(q, emb, K, nr, block_t=bt)
        st = topk.fused_score_topk(q, emb, K, nr)
        differ = int((tp[1] != st[1]).any(dim=1).sum())
        check(differ == 0 and torch.equal(tp[0], st[0]),
              f"twophase vs streaming on random {dtype} unit rows: {differ} query rows differ")
        log(f"twophase vs streaming on random {dtype} unit rows, B=4096: 0 of 4096 query rows "
            f"differ [{card}]")
        del emb, q
        torch.cuda.empty_cache()
    twophase_costs(card)


def check_topk_exact(card: str, results: dict) -> None:
    """The exact variant (kernel 6, counter topk_exact) against
    topk_reference(variant="exact") on the 1,249,280-row index in bf16,
    int8 and f32, num_real = T_pad - 1000, on exact-dot inputs (float
    indexes: multiples of 1/16; int8: exact integer sums), so rows and
    values must match bit for bit: B = 8 and 256, B = 4096 on a 512-query
    subset of the plain version, a sparse query whose products are all
    -0.0, and num_real in {0, 5} (sinks exactly float32(-3e38), row 0)."""
    from sse_tpu_torch.index.sharded_index import quantize_rows
    from sse_tpu_torch.ops import topk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    nr = T_PAD - 1000
    ex = dict(variant="exact")
    r = results["topk_exact"]
    for dtype in ("bf16", "int8", "f32"):
        if dtype == "int8":
            emb = quantize_rows(unit_rows(T_PAD, gen), torch.int8)
            q_all = topk.quantize_queries_int8(unit_rows(4096, gen))
        else:
            emb, q_all = exact_dot((T_PAD, D), gen), exact_dot((4096, D), gen)
            if dtype == "f32":
                emb, q_all = emb.float(), q_all.float()
        times = []
        for B in (8, 256, 4096):
            q = q_all[:B].contiguous()
            got = topk.fused_score_topk(q, emb, K, nr, **ex)
            sub = slice(0, min(B, 512))  # the full [4096, T] reference would be 20 GB
            want = topk.topk_reference(q[sub], emb, K, nr, **ex)
            err = same(f"topk_exact {dtype} B={B}", (got[0][sub], got[1][sub]), want)
            r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
            ms = cuda_ms(lambda: topk.fused_score_topk(q, emb, K, nr, **ex), reps=5 if B < 4096 else 2)
            times.append(f"B={B} {ms:.4f} ms")
            if B == 8:
                plain = cuda_ms(lambda: topk.topk_reference(q, emb, K, nr, **ex), reps=2)
                times[-1] += f" (plain {plain:.4f})"
            if dtype == "bf16":
                at = dict(ms=ms, **bound(nbytes(q, emb, *got), 2.0 * B * nr * D))
                r.setdefault("at_batch", {})[str(B)] = at
                if B == 8:
                    r.update(plain_ms=plain, library_ms=None, **at)
        hold_stream_edges(f"topk_exact {dtype}", q_all, emb, "exact")
        if dtype != "int8":  # q·e made of -0.0 products: ties with +0.0, lower row first
            qz = torch.zeros((8, D), device="cuda", dtype=emb.dtype)
            qz[:, 0] = -1.0
            ez = torch.full((4096, D), -0.5, device="cuda", dtype=emb.dtype)
            ez[:, 0] = 0.0
            ez[77, 0] = -0.25
            got = topk.fused_score_topk(qz, ez, K, 4096, **ex)
            same(f"topk_exact {dtype} -0.0 products", got, topk.topk_reference(qz, ez, K, 4096, **ex))
            check(got[1][0].tolist() == [77] + list(range(K - 1)), "-0.0 ties: lower rows first")
        log(f"topk_exact {dtype} T={T_PAD} num_real={nr} k={K}: bit-identical to plain "
            f"(B=4096 on a 512-query subset)"
            + f", at num_real {STREAM_EDGES} with sinks exactly -3e38 and row 0, zero query "
            f"rows, under sync debug"
            + f"{', -0.0 products tie to the lower row' if dtype != 'int8' else ''}; kernel "
            + ", ".join(times) + f" [{card}]")
        del emb, q_all
        torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 3
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_json(url: str, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            raise AssertionError(f"{url}: HTTP {r.status}")
        return json.loads(r.read())


def served_corpus():
    """The served slices' documents: the ranking demo corpus' 1,024
    targets plus random word strings up to T_PAD - 1000 rows, encoded at
    L=50 (host work, shared by the served slices; the vocab build, its
    token counts and the encode run in the C++ encoder). Returns ((vocab,
    target space, eval pairs), host seconds by part)."""
    from sse_tpu_torch.data import synthetic
    from sse_tpu_torch.data.corpus import build_vocab, encode_target_space

    t0 = time.perf_counter()
    train, evalp, targets = synthetic.make_corpus(task="ranking", num_targets=1024, seed=SEED)
    t1 = time.perf_counter()
    vocab = build_vocab(8000, train, targets)
    t2 = time.perf_counter()
    words = sorted({w for _, t in targets for w in t.split()})
    rnd = random.Random(SEED)
    docs = list(targets) + [
        (f"x{i:07d}", " ".join(rnd.choices(words, k=rnd.randint(3, 8))))
        for i in range(T_PAD - 1000 - len(targets))
    ]
    t3 = time.perf_counter()
    tspace = encode_target_space(vocab, docs, 50)
    t4 = time.perf_counter()
    secs = {"demo corpus": t1 - t0, "vocab build": t2 - t1, "documents": t3 - t2,
            "encode": t4 - t3, "total": t4 - t0}
    log(f"corpus: {len(docs)} documents, vocab {vocab.vocab_size}, "
        f"token width {tspace.tokens.shape[1]} ({secs['total']:.1f} s host: "
        + ", ".join(f"{k} {v:.2f}" for k, v in secs.items() if k != "total") + ")")
    return (vocab, tspace, evalp), secs


# the CPU tests' odd strings (tests/test_text.py SAMPLES; the escape blowup,
# lone surrogates and NULs of tests/test_torch_native.py), held C++ against
# Python on the card's host with 300 random strings over their alphabet
ODD_TEXTS = [
    "", "hello world", "Hello, World!", "  leading and trailing  ", "tabs\tand\nnewlines",
    "unicode: caffè, naïve, 北京 2024!", "e-commerce query: iphone 12 pro max 256gb unlocked",
    "underscore_token and back\\slash", "semicolons; and \\123; fake escapes",
    "ümlaut ÅÄÖ ß … emoji 🙂 mixed", "a b", " ", "_", "\\", "123 456.789",
    "{" * 200, "~{}" * 100, "e{" * 150, "{",
    "\ud800", "x \udfff y", "🙂 pair of halves", "a\x00b", "\x00", "nul\x00 \x00",
]
ENCODE_BATCHES = (8, 256, 4096)
# what the encode slice's bulk POSTs (B=4096, packed) launch
ENCODE_KERNELS = ("gru_fwd", "twophase_p1", "twophase_p2")


def odd_texts() -> list:
    import string

    rng = random.Random(0)
    chars = string.printable + "éß北🙂_\\;caffènaïve"
    return ODD_TEXTS + ["".join(rng.choice(chars) for _ in range(rng.randrange(60)))
                        for _ in range(300)]


def host_ms(fn, reps: int) -> float:
    """Median host milliseconds of fn() over ``reps`` calls after a warm
    one (the host's clock: these are host readings)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def same_arrays(label: str, got, want) -> None:
    for name, g, w in zip(("tokens", "lengths"), got, want):
        if not np.array_equal(g, w):
            bad = np.argwhere(g != w)[:5].tolist() if g.shape == w.shape else (g.shape, w.shape)
            raise AssertionError(f"{label}: {name} differ at {bad}")


def timed_query_path(engine, python: bool, spans: dict):
    """A context in which ``engine``'s bulk path records the host seconds
    of each tokenize (``corpus.batch_encode``: the plain Python loop if
    ``python``, else itself), each ``encode_queries`` and each ``query``
    into ``spans``' lists, inside the calls that serve the POSTs."""
    import contextlib

    from sse_tpu_torch.data import corpus as corpus_mod

    def timed(name, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spans.setdefault(name, []).append(time.perf_counter() - t0)
        return run

    @contextlib.contextmanager
    def ctx():
        native = corpus_mod.batch_encode
        corpus_mod.batch_encode = timed(
            "tokenize", corpus_mod.batch_encode_python if python else native)
        engine.encode_queries = timed("encode_queries", engine.encode_queries)
        engine.query = timed("query", engine.query)
        try:
            yield
        finally:
            corpus_mod.batch_encode = native
            del engine.encode_queries, engine.query

    return ctx()


def median_ms(xs) -> float:
    return sorted(xs)[len(xs) // 2] * 1e3


def encode_slice(card: str) -> tuple:
    """The C++ subword encoder on the card machine's host (``--encode``
    runs it alone): its build; the served corpus' 1,248,280 documents at
    L=50 and the odd strings, C++ against the plain Python encoder bit for
    bit; token counts and the vocab build against Python; batch_encode's
    host ms at B=8, 256 and 4096, C++ beside Python; served_corpus end to
    end; one bulk POST of 4,096 texts to the served GRU model split into
    tokenize, host to device, device and the rest, under each tokenizer
    (rows equal). Returns (the served corpus, the kernels' launch counts
    of its served run, its readings for the encode line)."""
    from sse_tpu_torch import native, ops
    from sse_tpu_torch.data import corpus as corpus_mod
    from sse_tpu_torch.data import synthetic
    from sse_tpu_torch.index import build_index
    from sse_tpu_torch.models import sse
    from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
    from sse_tpu_torch.models.towers import TowerConfig
    from sse_tpu_torch.serve import QueryEngine, serve_http
    from sse_tpu_torch.text import subword

    t0 = time.perf_counter()
    native.build_library()
    out = {"build_s": time.perf_counter() - t0}
    log(f"encoder build (host c++): {out['build_s']:.2f} s, "
        f"{native.binding.build_info['seconds']} s compiling")

    corpus, out["served_corpus_s"] = served_corpus()
    vocab, tspace, evalp = corpus
    texts = tspace.texts
    t0 = time.perf_counter()
    plain = corpus_mod.batch_encode_python(vocab, texts, 50)
    t1 = time.perf_counter()
    fast = corpus_mod.batch_encode(vocab, texts, 50)
    t2 = time.perf_counter()
    same_arrays(f"{len(texts)} served documents, C++ against Python", fast, plain)
    same_arrays("the served target space", (tspace.tokens, tspace.lengths),
                (plain[0][:, : tspace.tokens.shape[1]], plain[1]))
    out["documents"] = {"n": len(texts), "cpp_s": t2 - t1, "python_s": t1 - t0}
    odd = odd_texts()
    enc = native.NativeSubwordEncoder(vocab)
    for text in odd:
        check(enc.encode(text) == vocab.encode(text), f"C++ encode differs on {text[:40]!r}")
    same_arrays("odd strings", corpus_mod.batch_encode(vocab, odd, 50),
                corpus_mod.batch_encode_python(vocab, odd, 50))
    log(f"encode parity: {len(texts)} served documents at L=50 and {len(odd)} odd strings, C++ "
        f"== Python bit for bit; C++ {t2 - t1:.2f} s, Python {t1 - t0:.2f} s (host)")

    train, _, targets = synthetic.make_corpus(task="ranking", num_targets=1024, seed=SEED)
    lines = [s for s, _ in train] + [t for _, t in targets]
    counts = native.native_token_counts(lines)
    check(counts == subword.token_counts_from_lines(lines), "C++ token counts differ")
    out["vocab_build_s"] = {}
    for mc in (1, 2, 5):
        secs, built = {}, {}
        for name, use_native in (("cpp", True), ("python", False)):
            t0 = time.perf_counter()
            v = subword.SubwordVocab.build_from_token_counts(
                counts, mc, max_subtoken_length=20, use_native=use_native)
            secs[name] = time.perf_counter() - t0
            built[name] = [v.id_to_subtoken(i) for i in range(v.vocab_size)]
        check(built["cpp"] == built["python"], f"C++ vocab build differs at min_count {mc}")
        out["vocab_build_s"][f"min_count {mc}"] = secs
    log(f"token counts and vocab builds (min_count 1, 2, 5): C++ == Python; host s "
        f"{json.dumps(out['vocab_build_s'])}")

    queries = [q for q, _ in evalp]
    out["batch_encode_ms"] = {}
    for b in ENCODE_BATCHES:
        reps = {8: 200, 256: 50, 4096: 10}[b]
        out["batch_encode_ms"][b] = {
            "cpp": host_ms(lambda: corpus_mod.batch_encode(vocab, queries[:b], 50), reps),
            "python": host_ms(lambda: corpus_mod.batch_encode_python(vocab, queries[:b], 50),
                              reps)}
    log(f"batch_encode host ms at B=8/256/4096 (query texts, L=50, median): "
        f"{json.dumps(out['batch_encode_ms'])} [host of {card}]")

    width = dict(vocab_size=8000, embed_dim=128, hidden=128, num_layers=1, encoding_dim=128)
    cfg = SSEConfig(mode=NetworkMode.SHARED_ENCODER, src_tower=TowerConfig(cell="gru", **width))
    params = sse.init_params(cfg, torch.Generator().manual_seed(SEED))
    index = build_index(params, cfg, tspace, batch_size=4096, dtype=torch.bfloat16,
                        capacity=T_PAD)
    engine = QueryEngine(params, cfg, vocab, index, max_seq_length=50, max_batch=8, k=K,
                         bulk_batch=4096)
    engine.warmup()
    bulk = queries[:4096]
    check(len(bulk) == 4096, f"{len(bulk)} eval texts, want 4096")
    server = serve_http(engine, port=free_port(), block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}/api/query"
    ops.reset_launch_counts()
    out["bulk_post_4096_ms"], rows = {}, {}
    try:
        for name, python in (("cpp", False), ("python", True)):
            spans, per = {}, collections.defaultdict(list)
            with timed_query_path(engine, python, spans):
                rows[name] = http_json(url, {"queries": bulk})["results"]  # warm
                for _ in range(5):
                    spans.clear()
                    t0 = time.perf_counter()
                    http_json(url, {"queries": bulk})
                    per["post"].append(time.perf_counter() - t0)
                    for key in ("tokenize", "encode_queries", "query"):
                        per[key].append(sum(spans[key]))
                    per["dispatches"].append(len(spans["query"]))
                # the batcher may dispatch a POST's first texts before the
                # rest are queued, so the device time is read around POSTs
                times = profiled(lambda: http_json(url, {"queries": bulk}), 3)
            device = NOT_MEASURED if times is None else sum(
                v for k, v in times.items() if "Memcpy" not in k) / 3
            split = {
                "post": median_ms(per["post"]), "tokenize": median_ms(per["tokenize"]),
                "host_to_device": median_ms(
                    [e - t for e, t in zip(per["encode_queries"], per["tokenize"])]),
                "device": device,
                "device_copies": NOT_MEASURED if times is None else sum(
                    v for k, v in times.items() if "Memcpy" in k) / 3,
                "engine_other": median_ms(
                    [q - e for q, e in zip(per["query"], per["encode_queries"])]) - device,
                "http_and_json": median_ms([p - q for p, q in zip(per["post"], per["query"])]),
                "dispatches": sorted(per["dispatches"]),
            }
            split["rest"] = split["post"] - split["tokenize"] - split["host_to_device"] - device
            out["bulk_post_4096_ms"][name] = split
    finally:
        server.shutdown()
        server.server_close()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    BATCH_LAUNCHES.update(ops.topk.launches)
    check([[h["row"] for h in r] for r in rows["cpp"]]
          == [[h["row"] for h in r] for r in rows["python"]],
          "the bulk POST's rows differ between the C++ and the Python tokenizer")
    n = same_as_reference(engine, params, cfg, index, bulk, rows["cpp"])
    log(f"bulk POST of 4,096 texts to the served GRU model, host ms (medians of 5 POSTs, each "
        f"part summed over the dispatches that served it; device and its copies from "
        f"torch.profiler around 3 POSTs; rest = post - tokenize - host_to_device - device "
        f"= engine_other (the fused call's host path, the wait, the results) + "
        f"http_and_json): "
        f"{json.dumps(out['bulk_post_4096_ms'])}; rows equal under both tokenizers and held "
        f"against topk_reference ({n} positions differ, each within one key bucket); "
        f"launches {counts} [{card}]")
    return corpus, counts, out


# main-path launches of the top-k kernels by (name, batch size) (served runs)
BATCH_LAUNCHES = collections.Counter()


def served_slice(label: str, cfg, corpus, posts: tuple, variant: str = "packed") -> dict:
    """Build the 1,249,280-row bf16 index with ``cfg``'s seeded weights,
    serve it over HTTP with the engine's top-k ``variant``, send four GET
    queries (the B=8 tier) and one POST of each size in ``posts`` (one
    bulk dispatch each), and hold the served rows against topk_reference
    of that variant. Returns the kernels' launch counts from this run
    (reset just before it)."""
    from sse_tpu_torch import ops
    from sse_tpu_torch.index import build_index
    from sse_tpu_torch.models import sse
    from sse_tpu_torch.serve import QueryEngine, serve_http

    vocab, tspace, evalp = corpus
    params = sse.init_params(cfg, torch.Generator().manual_seed(SEED))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    index = build_index(params, cfg, tspace, batch_size=4096, dtype=torch.bfloat16,
                        capacity=T_PAD)
    torch.cuda.synchronize()
    check(index.padded_size == T_PAD and index.num_real == tspace.num_targets, "index geometry")
    log(f"{label} build_index: {index.num_real} rows in a {index.padded_size}-row bf16 index, "
        f"{time.perf_counter() - t0:.2f} s")
    engine = QueryEngine(params, cfg, vocab, index, max_seq_length=50, max_batch=8, k=K,
                         bulk_batch=4096, pallas_variant=variant)
    log(f"{label} warmup: {engine.warmup():.2f} s")
    server = serve_http(engine, port=free_port(), block=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    known = set(index.ids[: index.num_real])
    get_texts = [s for s, _ in evalp[:4]]
    got = []
    try:
        check(http_json(base + "/healthz")["status"] == "ok", "/healthz")
        for text in get_texts:
            url = base + "/api/query?keywords=" + urllib.request.quote(text)
            hits = http_json(url)["results"]
            check(len(hits) == K and all(h["targetId"] in known for h in hits), f"GET: {hits}")
            got.append(hits)
        bulk = []
        for n_post in posts:
            texts = [s for s, _ in evalp[:n_post]]
            check(len(texts) == n_post, f"{label}: {len(texts)} eval texts, want {n_post}")
            t0 = time.perf_counter()
            served = http_json(base + "/api/query", {"queries": texts})["results"]
            log(f"{label} POST /api/query with {len(texts)} texts: "
                f"{time.perf_counter() - t0:.3f} s")
            bulk.append((texts, served))
        stats = http_json(base + "/api/stats")
    finally:
        server.shutdown()
        server.server_close()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    BATCH_LAUNCHES.update(ops.topk.launches)
    log(f"{label} launches during the served run: {counts}, top-k by batch size "
        f"{dict(ops.topk.launches)}; server stats: queries={stats['queries']}")
    split = query_split(engine, get_texts[0])
    log(f"{label} one query at the B=8 tier (engine.query, torch.profiler, ms per query): "
        f"device {sum(split.values()):.4f}; "
        + json.dumps({k[:60]: round(v, 4) for k, v in sorted(split.items(), key=lambda kv: -kv[1])}))
    if cfg.src_tower.cell == "lstm":
        parts = query_parts(engine, get_texts[0])
        log(f"{label} one query at the B=8 tier by part (torch.profiler, device ms per query): "
            f"{sum(parts.values()):.4f}: "
            + json.dumps({k: round(v, 4) for k, v in sorted(parts.items(), key=lambda kv: -kv[1])}))
    for texts, served in bulk:
        check(len(served) == len(texts), "POST: one result list per query")
        for hits in served:
            check(len(hits) == K and all(h["targetId"] in known for h in hits), f"POST: {hits}")

    if variant == "exact":
        check(counts["topk_exact"] > 0 and counts["twophase_p1"] == counts["twophase_p2"]
              == counts["topk_stream"] == 0,
              f"{label}: the exact engine must stream every batch: {counts}")
    tol = "within 2e-6" if variant == "exact" else "each within one key bucket"
    for name, tx, res in (("GET", get_texts, got), *(("POST", t, r) for t, r in bulk)):
        n = same_as_reference(engine, params, cfg, index, tx, res, variant)
        log(f"{label}: served rows == topk_reference(variant={variant!r}) for {len(tx)} "
            f"{name} queries ({n} positions differ, the two rows' scores {tol})")
    return counts


# kernel name pattern → part of a served query (query_parts)
QUERY_PARTS = {"rnn_scan_kernel": "LSTM scan", "gates_product_kernel": "x-product",
               "gru_fwd_kernel": "GRU", "stream": "top-k", "select": "top-k",
               "blockmax": "top-k", "pairs": "top-k"}


def query_parts(engine, text: str, reps: int = 5) -> dict:
    """Device ms of one served query by part (torch.profiler with the CPU
    activity, after a warm query): the device's kernels and copies, the
    recurrent kernels and the top-k by kernel name (QUERY_PARTS), of the
    others what the CPU ops inside the ``sse.tower.readout`` range
    launched as the readout, the rest as other."""
    engine.query([text])
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            engine.query([text])
        torch.cuda.synchronize()

    def in_readout(e) -> bool:
        while e is not None:
            if e.name == "sse.tower.readout":
                return True
            e = e.cpu_parent
        return False

    readout = collections.Counter()  # kernel → ms launched inside the readout range
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and in_readout(e):
            for k in e.kernels:
                if k.name != e.name and not k.name.startswith("sse."):
                    readout[k.name] += k.duration / 1000.0
    out, other = collections.Counter(), collections.Counter()
    for name, ms in device_times(prof).items():
        if name.startswith("sse."):
            continue  # a range's device span
        part = next((p for pat, p in QUERY_PARTS.items() if pat in name), None)
        if part is None:
            r = min(ms, readout[name])
            out["attention readout"] += r / reps
            part, ms = "other", ms - r
            other[name[:50]] += ms / reps
        out[part] += ms / reps
    log(f"query_parts: the largest of other: "
        f"{[(n, round(v, 4)) for n, v in other.most_common(4)]}")
    return dict(out)


def qna_query_costs(card: str) -> dict:
    """One served qna query at the B=8 tier (``engine.query``: the qna
    towers at E=H=D=128, random weights from the seed, L=50) on a
    1,249,280-row bf16 index of random unit rows, by part (query_parts)."""
    from sse_tpu_torch.data import synthetic
    from sse_tpu_torch.data.corpus import build_vocab
    from sse_tpu_torch.index.sharded_index import ShardedIndex
    from sse_tpu_torch.models import sse
    from sse_tpu_torch.serve import QueryEngine

    train, evalp, targets = synthetic.make_corpus(task="ranking", num_targets=1024, seed=SEED)
    cfg = qna_config()
    params = sse.init_params(cfg, torch.Generator().manual_seed(SEED))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    nr = T_PAD - 1000
    index = ShardedIndex(emb=unit_rows(T_PAD, gen).bfloat16(), num_real=nr,
                         ids=[f"x{i}" for i in range(nr)], texts=[""] * nr)
    engine = QueryEngine(params, cfg, build_vocab(8000, train, targets), index,
                         max_seq_length=50, max_batch=8, k=K)
    parts = query_parts(engine, evalp[0][0])
    log(f"qna query at the B=8 tier by part (torch.profiler, device ms per query): "
        f"{sum(parts.values()):.4f}: "
        + json.dumps({k: round(v, 4) for k, v in sorted(parts.items(), key=lambda kv: -kv[1])})
        + f" [{card}]")
    return parts


def query_split(engine, text: str, reps: int = 5) -> dict:
    """Device ms of each kernel and copy of one served query, from
    torch.profiler over ``reps`` queries after a warm one."""
    engine.query([text])
    times = profiled(lambda: engine.query([text]), reps)
    if times is None:
        return {"not measured": NOT_MEASURED}
    return {k: v / reps for k, v in times.items()}


def same_as_reference(engine, params, cfg, index, texts, served, variant="packed") -> int:
    """Served rows against topk_reference on the same query encodings and
    index (rows_near_reference). Returns the count of differing positions."""
    from sse_tpu_torch.models import sse

    tokens, lengths = engine.encode_queries(texts)
    with torch.no_grad():
        q = sse.encode_source(params, cfg, tokens, lengths)[: len(texts)]
    rows = torch.tensor([[h["row"] for h in hits] for hits in served], device="cuda")
    return rows_near_reference(q, index.emb, index.num_real, rows, variant)


def rows_near_reference(q, emb, nr: int, rows, variant: str = "packed") -> int:
    """Top-k ``rows`` [B, k] of the queries ``q`` against topk_reference on
    the same inputs, within the kernels' tolerance (rows_off_reference:
    a differing position only where the two rows' scores lie within one
    key bucket, or 2e-6 on the exact variant; none on an int8 index).
    Returns the count of differing positions."""
    from sse_tpu_torch.ops import topk

    n, bad = topk.rows_off_reference(q, emb, rows, nr, variant)
    check(not bad, f"{len(bad)} of {n} differing {variant} rows beyond the tolerance "
          f"(i, j, score, reference's score): {bad[:5]}")
    return n


# ------------------------------------------------------------ the bench
# the query bench's runs on the card: label → (index dtype, B); every run
# is k=10 on the 1,249,280-row index (bench.HEADLINE_ROWS)
BENCH_QUERIES = {
    "bench query bf16 B=4096": (torch.bfloat16, 4096),
    "bench query bf16 B=8": (torch.bfloat16, 8),
    "bench query bf16 B=256": (torch.bfloat16, 256),
    "bench query int8 B=4096": (torch.int8, 4096),
}


def bench_kernels(b: int) -> tuple:
    """The kernels a query batch of b launches (the engine's route)."""
    from sse_tpu_torch.ops.topk import TWOPHASE_MIN_BATCH

    return ("gru_fwd", "twophase_p1", "twophase_p2") if b >= TWOPHASE_MIN_BATCH else (
        "gru_fwd", "topk_stream")


def window_busy(s, tries: int = 3, want: str = "gru_fwd") -> tuple:
    """Wall ms of one window (bench.WINDOW) of the query bench's dispatches (``s``: a
    bench.QuerySetup) ending in a drain, under torch.profiler, and the
    device's busy ms in it (its kernels and copies). Profiles again when
    the session saw fewer launches of the kernel named ``want`` (the GRU
    forward by default) than dispatches; busy is NOT_MEASURED if every
    session lost them (see profiled)."""
    from sse_tpu_torch import bench

    window = bench.WINDOW
    s.call(s.variants[0])
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(window):
                s.call(s.variants[1 + i % (len(s.variants) - 1)])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        counts = {}
        times = device_times(prof, counts)
        if sum(c for name, c in counts.items() if want in name) >= window:
            return wall, sum(v for name, v in times.items() if not name.startswith("sse."))
        warn(f"torch.profiler lost {want} launches of a bench window: {json.dumps(counts)}")
    warn(f"torch.profiler lost the {want} launches of a bench window in {tries} sessions: "
         f"its busy share is not measured")
    return wall, NOT_MEASURED


def bench_slice(card: str) -> dict:
    """The port's benchmark on the card (sse_tpu_torch.bench, its own
    random data made on the card): the query bench at k=10 on the
    1,249,280-row index (BENCH_QUERIES), the train bench and the index
    bench at the JAX bench's default shapes, each with a shortened
    ``seconds``. Each result prints as JSON, each run must launch its
    path's kernels (launch counts reset just before it), and each query
    run's first batch, from the very setup that was timed
    (bench.first_batch), must hold against topk_reference. Logs the
    device's busy share of one window at B=8 and B=4096. The train
    bench's setup then also gives the GRU train step's per-step launches
    and split (train_bench_slice). Returns each run's launch counts."""
    from sse_tpu_torch import bench, ops

    runs = {}

    def counted(label: str, names, fn):
        ops.reset_launch_counts()
        result = fn()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        BATCH_LAUNCHES.update(ops.topk.launches)
        missing = [n for n in names if counts[n] < 1]
        check(not missing, f"{label}: kernels never launched: {missing} ({counts})")
        check(result["value"] > 0 and result["device"] == torch.cuda.get_device_name(0),
              f"{label}: {result}")
        log(f"{label}: {json.dumps(result)}; launches {counts} [{card}]")
        runs[label] = counts
        return result

    for label, (dtype, b) in BENCH_QUERIES.items():
        s = bench.query_setup(num_targets=bench.HEADLINE_ROWS, encoding_dim=D, batch=b, k=K,
                              max_seq_length=50, index_dtype=dtype)
        result = counted(label, bench_kernels(b), lambda: bench.time_query(s, 1.0))
        check(all(key in result for key in ("mfu_pct", "hbm_pct_of_spec")) or
              bench._chip_spec(result["device"]) is None, f"{label}: no roofline fields")
        vals, rows, n, bad = bench.first_batch(s)
        check(not bad, f"{label}: {len(bad)} of {n} differing rows beyond the tolerance "
              f"(i, j, score, reference's score): {bad[:5]}")
        check(bool(torch.isfinite(vals).all()) and tuple(rows.shape) == (b, K)
              and int(rows.max()) < s.num_real, f"{label}: first batch {vals}, {rows}")
        log(f"{label}: the timed setup's first batch == topk_reference on the bench's index "
            f"({n} of {rows.numel()} positions differ, each within the kernels' tolerance)")
        if dtype == torch.bfloat16 and b in (8, 4096):
            wall, busy = window_busy(s)
            w = bench.WINDOW
            log(f"{label}: one window of {w} dispatches under torch.profiler: wall {wall:.4f} "
                f"ms, device busy {busy:.4f} ms ({100.0 * busy / wall:.1f}% of the profiled "
                f"window), {wall / w:.4f} ms a dispatch; busy {busy / w:.4f} ms a dispatch is "
                f"{100.0 * busy / w / result['ms_per_batch']:.1f}% of the bench's unprofiled "
                f"best window ({result['ms_per_batch']} ms a dispatch) [{card}]")
        del s, vals, rows
        torch.cuda.empty_cache()
    train = bench.train_setup()
    counted("bench train", ("gru_fwd", "gru_bwd"), lambda: bench.time_train(train, 2.0))
    runs["GRU train bench"] = train_bench_slice(card, "GRU train bench", train,
                                                {"gru_fwd": 2, "gru_bwd": 2})
    counted("bench index", ("gru_fwd",), lambda: bench.run_index_bench(seconds=1.0))
    return runs


SWEEP_BATCHES = (8, 256, 512, 1024, 2048, 4096)
NORTH_STAR_ROWS = 9_998_336  # 2048 x 4882: the north star's 10M items on one card


def route_call(s, route: str):
    """The bench's query path (``s``: a bench.QuerySetup) with the top-k
    route forced: encode, then the streaming or the two-phase call."""
    from sse_tpu_torch.models import sse
    from sse_tpu_torch.ops import topk

    bt = topk.twophase_block_t(s.emb.shape[0], s.k)

    def call(tokens):
        with torch.no_grad():
            q = sse.encode_source(s.params, s.model_cfg, tokens, s.lengths)
            if route == "two-phase":
                return topk.fused_score_topk_twophase(q, s.emb, s.k, s.num_real, block_t=bt)
            return topk.fused_score_topk(q, s.emb, s.k, s.num_real)

    return call


def bench_sweep(card: str) -> None:
    """``--bench``: the query bench (1 s a point) at B in SWEEP_BATCHES x k
    in {10, 100} x bf16, int8 and float32 on the 1,249,280-row index, each
    point with the route the engine took; bf16 k=10 at 9,998,336 rows
    (B=256 and 4096); then both top-k routes forced end to end (encode +
    streaming, encode + two-phase) at B=256..4096, k=10 and 100, bf16 and
    int8: where the route crossover falls for a caller."""
    from sse_tpu_torch import bench, ops

    def point(b, k, dtype, rows=bench.HEADLINE_ROWS) -> str:
        ops.reset_launch_counts()
        r = bench.run_query_bench(num_targets=rows, encoding_dim=D, batch=b, k=k, seconds=1.0,
                                  max_seq_length=50, index_dtype=dtype)
        route = "two-phase" if ops.launch_counts()["twophase_p1"] else "streaming"
        torch.cuda.empty_cache()
        return (f"B={b} {r['value']} qps ({route}; {r['ms_per_batch']} ms a batch, stream mean "
                f"{r['qps_stream_mean']}, mfu {r.get('mfu_pct')}%, hbm {r.get('hbm_pct_of_spec')}%)")

    for dtype in (torch.bfloat16, torch.int8, torch.float32):
        for k in (10, 100):
            cells = [point(b, k, dtype) for b in SWEEP_BATCHES]
            log(f"bench sweep {str(dtype)[6:]} k={k}, T={bench.HEADLINE_ROWS}: "
                + "; ".join(cells) + f" [{card}]")
    cells = [point(b, K, torch.bfloat16, NORTH_STAR_ROWS) for b in (256, 4096)]
    log(f"bench sweep bfloat16 k={K}, T={NORTH_STAR_ROWS}: " + "; ".join(cells) + f" [{card}]")

    for dtype in (torch.bfloat16, torch.int8):
        for k in (10, 100):
            cells = []
            for b in SWEEP_BATCHES[1:]:
                s = bench.query_setup(num_targets=bench.HEADLINE_ROWS, encoding_dim=D, batch=b,
                                      k=k, max_seq_length=50, index_dtype=dtype)
                qps = {}
                for route in ("streaming", "two-phase"):
                    best, _ = bench._throughput_time(route_call(s, route), s.variants, 1.0)
                    qps[route] = b / best
                cells.append(f"B={b} streaming {qps['streaming']:.1f} / two-phase "
                             f"{qps['two-phase']:.1f} qps")
                del s
                torch.cuda.empty_cache()
            log(f"bench routes {str(dtype)[6:]} k={k} (end to end, best window, qps): "
                + "; ".join(cells) + f" [{card}]")


# ------------------------------------------------------------ phase 4
# autograd op → part (the port's recurrent layer: GRU or LSTM kernels)
OWN_OPS = {"RNNLayer": "RNNLayer (layer forward)",
           "RNNLayerBackward": "RNNLayerBackward (layer backward)"}
OUTSIDE = "outside the ranges"


def step_split(prof) -> tuple:
    """Device ms of a profiled run's kernels by the part of the train step
    that launched them; returns (part → ms, {part → {kernel → ms}} for
    the parts a reader should check by name).

    A kernel belongs to the innermost op that launched it (the profiler's
    correlation). Walking up from that op, the first of these decides:
    the port's recurrent layer op (``RNNLayer``, ``RNNLayerBackward``) is its own
    part; a ``sse.*`` profiler range is the part; a backward node stands
    for the forward op of its sequence number (autograd runs a CUDA
    backward on its own thread, outside ``sse.train.backward``), and the
    part is "backward of" that op's part. Kernels under none of these are
    OUTSIDE."""
    cpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    fwd_op = {}
    for e in cpu:  # in order of start: ops that make no node carry the next
        if e.sequence_nr >= 0 and not e.fwd_thread:  # number, so keep the last
            fwd_op[(e.thread, e.sequence_nr)] = e

    def part_of(e, backward: bool = False):
        while e is not None:
            if e.name in OWN_OPS:
                return OWN_OPS[e.name]
            if e.name.startswith("sse."):
                return ("backward of " if backward else "") + e.name
            if not backward and e.fwd_thread and e.sequence_nr >= 0:
                f = fwd_op.get((e.fwd_thread, e.sequence_nr))
                return part_of(f, True) if f is not None else "backward (no forward op)"
            e = e.cpu_parent
        return "backward of " + OUTSIDE if backward else OUTSIDE

    split, names = {}, {}
    for e in cpu:
        for k in e.kernels:
            if k.name == e.name or k.name.startswith("sse."):
                continue  # the op's own device total, a range's device span
            part = part_of(e)
            split[part] = split.get(part, 0.0) + k.duration / 1000.0
            by_name = names.setdefault(part, {})
            by_name[k.name] = by_name.get(k.name, 0.0) + k.duration / 1000.0
    return split, {p: n for p, n in names.items() if OUTSIDE in p or "no forward" in p}


def train_bench_slice(card: str, label: str, s, per_step: dict) -> dict:
    """The train bench's step (``s``: a bench.TrainSetup; each call steps
    the same state, as the bench does): warm ms/step over 24 steps, the
    layer kernels' launches a step (``per_step``), the step's split
    (step_split). Returns the launch counts of the timed steps (reset
    just before them)."""
    from sse_tpu_torch import ops

    losses = []

    def run(n):
        for i in range(n):
            losses.append(s.call(s.variants[i % len(s.variants)]))

    run(3)
    torch.cuda.synchronize()
    n = 24
    ops.reset_launch_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run(n)
    end.record()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    ms_step = start.elapsed_time(end) / n
    check(all(counts[k] == v * n for k, v in per_step.items()),
          f"{label}: {n} steps launched {counts}, want {per_step} a step")
    check(bool(torch.isfinite(torch.stack(losses)).all()), f"{label}: non-finite loss")

    prof_steps = 8
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(prof_steps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1000.0 / prof_steps
    times = {k: v / prof_steps for k, v in device_times(prof).items()}
    # the step's profiler ranges also show as spans on the device timeline
    busy = sum(v for k, v in times.items() if not k.startswith("sse."))
    split, by_name = step_split(prof)
    split = {k: v / prof_steps for k, v in split.items()}
    linked = sum(split.values())
    split["not linked to an op"] = busy - linked
    per_step_json = lambda d: json.dumps(  # noqa: E731
        {k[:70]: round(v, 4) for k, v in sorted(d.items(), key=lambda kv: -kv[1])})
    tower = s.model_cfg.src_tower
    log(f"{label} (dual-encoder {tower.cell} x{tower.num_layers}, E={tower.embed_dim} "
        f"H={tower.hidden} D={tower.encoding_dim}, vocab {tower.vocab_size}, "
        f"L={s.max_seq_length}, B={len(s.lengths)}, {s.num_negatives} sampled negatives, "
        f"{len(s.tgt_tokens)} targets, Adam): {ms_step:.4f} ms/step over {n} warm steps "
        f"(CUDA events); launches {counts} [{card}]")
    log(f"{label} step split (torch.profiler, {prof_steps} steps, ms per step): wall "
        f"{wall:.4f}, device busy {busy:.4f} ({100.0 * busy / wall:.1f}%), host/idle "
        f"{wall - busy:.4f}; by the range or op that launched each kernel (step_split): "
        + per_step_json(split))
    for part, kernels in by_name.items():
        top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8])
        log(f"kernels of '{part}' (ms per step): "
            + per_step_json({k: v / prof_steps for k, v in top.items()}))
    return counts


RNN_KERNELS = ("gru_fwd", "gru_bwd", "lstm_fwd", "lstm_bwd", "rnn_scan")


def preset_slice(card: str, task_name: str, layer: str, recipe: str | None = None) -> dict:
    """A task preset (with a named ``recipe`` on top, where given) trained
    through train() on its demo corpus at the preset's widths, the
    Evaluator as eval_fn; then its EMA params serve one query through
    QueryEngine. ``layer`` is the preset's cell: for gru | lstm its
    forward and backward kernels must launch, for the transformer no
    recurrent kernel may. Returns the launch counts of the training run
    (reset just before it)."""
    from sse_tpu_torch.data import synthetic
    from sse_tpu_torch.data.corpus import build_vocab, encode_pairs, encode_target_space
    from sse_tpu_torch import configs, ops
    from sse_tpu_torch.evals import Evaluator
    from sse_tpu_torch.index import build_index
    from sse_tpu_torch.serve import QueryEngine
    from sse_tpu_torch.train import inference_params, init_train_state, train

    # 640 pairs / batch 128 = 5 steps an epoch: 60 epochs = 300 steps
    task = configs.preset(task_name, recipe=recipe, max_epochs=60, steps_per_checkpoint=50)
    rows, evrows, targets = synthetic.make_corpus(task=task_name, seed=SEED)
    vocab = build_vocab(task.vocab_size, rows, targets,
                        max_subtoken_length=task.max_subtoken_length, vocab_mode=task.vocab_mode)
    tspace = encode_target_space(vocab, targets, task.max_seq_length)
    pairs = encode_pairs(vocab, rows, tspace, task.max_seq_length)
    evpairs = encode_pairs(vocab, evrows, tspace, task.max_seq_length)
    mc = task.model_config(vocab.vocab_size, tspace.num_targets)
    check(mc.src_tower.cell == layer, f"{task_name}: cell {mc.src_tower.cell}")
    tc = task.train_config()
    evaluator = Evaluator(mc, evpairs, tspace)
    state = init_train_state(mc, tc)
    before = evaluator.evaluate(inference_params(state))
    records = []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state = train(mc, tc, pairs, tspace, eval_fn=evaluator.evaluate, log_fn=records.append,
                  state=state)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    if layer in ("gru", "lstm"):
        check(counts[f"{layer}_fwd"] > 0 and counts[f"{layer}_bwd"] > 0,
              f"{task_name}: launches {counts}")
    else:
        check(all(counts[k] == 0 for k in RNN_KERNELS),
              f"{task_name} ({layer}): a recurrent kernel launched: {counts}")
    check(all(math.isfinite(r["loss"]) for r in records), f"{task_name}: loss {records}")
    first, last = records[0], records[-1]
    check(last["loss"] < first["loss"], f"{task_name}: loss did not fall: {first} -> {last}")
    check(last["recall@1"] > before["recall@1"],
          f"{task_name}: recall@1 {before['recall@1']} at step 0 -> {last['recall@1']}")
    readout = mc.src_tower.readout
    if layer not in ("gru", "lstm") and readout != "attention":
        readout = "mean"  # what the transformer and bow towers read out for final | mean
    log(f"{task_name} preset ({layer} x{mc.src_tower.num_layers}, {readout} readout, "
        f"lr {tc.learning_rate}): {state.step} steps in "
        f"{secs:.2f} s (evals included), window loss {first['loss']:.4f} (step {first['step']}) "
        f"-> {last['loss']:.4f} (step {last['step']}), recall@1 {before['recall@1']:.4f} "
        f"(step 0) -> {last['recall@1']:.4f}, recall@10 {before['recall@10']:.4f} -> "
        f"{last['recall@10']:.4f}, lr {last['lr']:.6g}; launches {counts} [{card}]")

    params = inference_params(state)
    index = build_index(params, mc, tspace, batch_size=256, dtype=torch.bfloat16)
    engine = QueryEngine(params, mc, vocab, index, max_seq_length=task.max_seq_length,
                         max_batch=8, k=K)
    text = evrows[0][0]
    hits = engine.query([text])
    check(len(hits) == 1 and len(hits[0]) == K, f"{task_name} query: {hits}")
    n = same_as_reference(engine, params, mc, index, [text], hits)
    log(f"{task_name} EMA params served {text!r}: top-{K} rows == topk_reference "
        f"({n} positions differ, each within one key bucket); top hit {hits[0][0]['targetId']}")
    return counts


# Runs ``python -m sse_tpu_torch.cli <args>`` and, as the process exits,
# prints one log line with the kernels it launched.
CLI_RUNNER = (
    "import atexit, json, runpy, sys\n"
    "from sse_tpu_torch import ops\n"
    "atexit.register(lambda: print('[launches] ' + json.dumps(ops.launch_counts()), flush=True))\n"
    "sys.argv = ['sse_tpu_torch.cli', *sys.argv[1:]]\n"
    "runpy.run_module('sse_tpu_torch.cli', run_name='__main__', alter_sys=True)\n"
)


def cli_launches(stdout: str) -> dict:
    lines = [ln for ln in stdout.splitlines() if ln.startswith("[launches] ")]
    check(len(lines) == 1, f"no launch-count line in the CLI output:\n{stdout[-2000:]}")
    return json.loads(lines[0][len("[launches] "):])


def cli_slice(card: str) -> dict:
    """The model-dir path on the card, each command a subprocess of
    ``python -m sse_tpu_torch.cli`` (CLI_RUNNER): demo-data (ranking),
    train with the ranking preset at its own widths, index (with live-add
    headroom and a TSV export), eval, eval --use_index, visualize, bench
    --kind query over the model dir (its JSON, its kernels); then
    serve on a free port: a GET, POST /api/add, /api/save, a second train
    into the same model dir, /api/reload (its num_targets counts the added
    document, read back from the saved index) and a GET after it. Checks
    each command's exit code and output line; returns the kernels'
    launches summed over the commands, each counted by the process itself."""
    import os
    import shutil

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "cli_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    env = {k: v for k, v in os.environ.items() if k != "SSE_PLATFORM"}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    total: dict = {}
    secs = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def run(*args, want: str) -> str:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", CLI_RUNNER, *args], cwd=work, env=env,
                             capture_output=True, text=True, timeout=300)
        secs[args[0]] = secs.get(args[0], 0.0) + time.perf_counter() - t0
        check(out.returncode == 0, f"cli {' '.join(args)}: exit {out.returncode}\n{out.stderr[-3000:]}")
        check(want in out.stdout, f"cli {args[0]}: no {want!r} in\n{out.stdout[-2000:]}")
        add(cli_launches(out.stdout))
        return out.stdout

    def last_json(out: str) -> dict:
        return json.loads([ln for ln in out.splitlines() if ln.startswith("[sse] {")][-1][6:])

    t_all = time.perf_counter()
    run("demo-data", "--task", "ranking", "--out_dir", "data", want="[sse] wrote 1536 TrainPairs")
    train = ("train", "--data_dir", "data", "--model_dir", "run")
    out = run(*train, "--task_type", "ranking", "--max_epochs", "20",
              "--steps_per_checkpoint", "60", want="[sse] final eval: ")
    final = json.loads(out.split("[sse] final eval: ")[1].splitlines()[0])
    check(0.0 <= final["recall@1"] <= 1.0, f"final eval {final}")
    run("index", "--model_dir", "run", "--data_dir", "data", "--capacity", "128",
        "--export_tsv", "run/idx.tsv", want="[sse] built index: 64 targets, dim 128")
    plain = last_json(run("eval", "--model_dir", "run", "--data_dir", "data", want="recall@1"))
    via = last_json(run("eval", "--model_dir", "run", "--data_dir", "data", "--use_index",
                        want="recall@1"))
    run("visualize", "--model_dir", "run", "--out_dir", "viz", want="[sse] wrote 64x128 embeddings")
    out = run("bench", "--kind", "query", "--model_dir", "run", "--seconds", "1",
              want='{"metric": "queries_per_sec_exact_topk"')
    bench = json.loads([ln for ln in out.splitlines() if ln.startswith('{"metric"')][-1])
    check(bench["value"] > 0 and bench["num_targets"] == 64 and bench["k"] == K,
          f"cli bench: {bench}")
    missing = [n for n in bench_kernels(bench["batch"]) if cli_launches(out).get(n, 0) < 1]
    check(not missing, f"cli bench: kernels never launched: {missing}")
    log(f"cli bench --kind query --model_dir run: {json.dumps(bench)} [{card}]")

    port = free_port()
    t0 = time.perf_counter()
    server = subprocess.Popen(
        [sys.executable, "-c", CLI_RUNNER, "serve", "--model_dir", "run", "--port", str(port)],
        cwd=work, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    base = f"http://127.0.0.1:{port}"
    try:
        while True:
            if server.poll() is not None:
                raise AssertionError(f"cli serve exited: {server.communicate()[1][-3000:]}")
            check(time.perf_counter() - t0 < 300, "cli serve: not up after 300 s")
            try:
                if http_json(base + "/healthz")["status"] == "ok":
                    break
            except OSError:
                time.sleep(0.5)
        up = time.perf_counter() - t0
        hits = http_json(base + "/api/query?keywords=" + urllib.request.quote("alpha beta"))["results"]
        check(len(hits) == K, f"cli serve GET: {hits}")
        added = http_json(base + "/api/add", [{"targetId": "smoke1", "targetText": "smoke doc"}])
        check(added["num_targets"] == 65, f"/api/add: {added}")
        saved = http_json(base + "/api/save", {})
        check(saved["num_targets"] == 65, f"/api/save: {saved}")
        run(*train, "--max_epochs", "25", want="[sse] final eval: ")
        reloaded = http_json(base + "/api/reload", {})
        check(reloaded["num_targets"] == 65, f"/api/reload: {reloaded}")
        hits = http_json(base + "/api/query?keywords=" + urllib.request.quote("smoke doc"))["results"]
        check(len(hits) == K, f"GET after reload: {hits}")
        check(http_json(base + "/api/stats")["index_num_targets"] == 65, "stats after reload")
    finally:
        server.terminate()
        stdout, stderr = server.communicate(timeout=120)
    check(server.returncode == 0, f"cli serve: exit {server.returncode}\n{stderr[-3000:]}")
    check("[sse] serving 64 targets" in stdout, f"cli serve output:\n{stdout[-2000:]}")
    add(cli_launches(stdout))
    shutil.rmtree(work, ignore_errors=True)
    log(f"cli path (python -m sse_tpu_torch.cli, ranking preset E=H=D=128): final eval {final}, "
        f"eval {plain}, eval --use_index {via}; serve up in {up:.1f} s, GET, /api/add, "
        f"/api/save, a second train, /api/reload (num_targets 65), GET after it; seconds by "
        f"command {json.dumps({k: round(v, 1) for k, v in secs.items()})}, whole path "
        f"{time.perf_counter() - t_all:.1f} s; launches {total} [{card}]")
    return total


# ------------------------------------------------------ the transformer
def transformer_config():
    """The ``transformer`` recipe's model on the ``ranking`` preset at its
    full width: a dual-encoder of 4 pre-LN blocks, E=H=D=128, 4 heads,
    mlp_ratio 4, RoPE, vocab 8000."""
    from sse_tpu_torch import configs

    return configs.preset("ranking", recipe="transformer").model_config(8000, T_PAD)


def transformer_flops(tower, b: int, length: int) -> float:
    """A transformer tower's forward at B=b, L=length: per token and block
    the QKV, out-projection and MLP products and the attention's two
    (2·(3d² + d² + 2·r·d²) + 4·L·d), plus the projection a row."""
    d, r = tower.hidden, tower.mlp_ratio
    per_token = 2 * (3 * d * d + d * d + 2 * r * d * d) + 4 * length * d
    return b * length * tower.num_layers * per_token + 2 * b * d * tower.encoding_dim


def tower_inputs(tower, b: int, gen, length: int = 50, ragged: bool = False):
    """Random tokens [b, length] and lengths (all ``length``, or 0..length
    with a row of length 0 and one of length 1) on the card."""
    tokens = torch.randint(1, tower.vocab_size, (b, length), generator=gen, device="cuda")
    if not ragged:
        return tokens, torch.full((b,), length, dtype=torch.int32, device="cuda")
    lengths = torch.randint(0, length + 1, (b,), generator=gen, device="cuda")
    lengths[:2] = torch.tensor([0, 1], device="cuda")
    return tokens, lengths


FP32_GEMM = ("ffma", "f32f32_f32f32", "sgemm", "tf32")  # fp32 CUDA-core / TF32 GEMM names
GEMM = ("gemm", "nvjet", "cutlass", "xmma", "Kernel2")


def check_transformer(card: str) -> None:
    """The transformer tower on the card (the recipe's model, random
    weights from the seed, B=256, L=50, ragged lengths with a length-0 and
    a length-1 row): its body (``towers._transformer_encode``) with the
    card's products (``towers._dot``: bf16 tensor cores, float32 result)
    against the same body on ``bf16_matmul`` (float32 products of
    bf16-rounded operands) on the same card, params and tokens. The two
    sum in other orders, so a float32 difference may flip a bf16 rounding
    downstream: the states to 2e-2 (the JAX package's own tolerance for
    this tower's invariances), the params' gradients of a random linear
    function of the states to 3e-2 of each leaf's max-abs (the train-step
    parity's tolerance); then the whole tower's output: finite, unit
    norm."""
    from sse_tpu_torch.models import sse, towers
    from sse_tpu_torch.ops import rnn

    cfg = transformer_config()
    tower = cfg.src_tower
    params = sse.init_params(cfg, torch.Generator().manual_seed(SEED))["src_tower"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    tokens, lengths = tower_inputs(tower, 256, gen, ragged=True)
    valid = (torch.arange(50, device="cuda")[None, :] < lengths[:, None]).float()
    x = params["embed"][tokens.long()]
    p = {k: v for k, v in params.items() if k != "blocks"}
    p["blocks"] = [{k: v.detach().clone().requires_grad_() for k, v in blk.items()}
                   for blk in params["blocks"]]
    leaves = [(f"blocks[{i}].{k}", v) for i, blk in enumerate(p["blocks"])
              for k, v in sorted(blk.items())]
    w = torch.randn((256, 50, tower.hidden), generator=gen, device="cuda")

    def run(dot):
        states = towers._transformer_encode(p, tower, x, valid, dot=dot)
        grads = torch.autograd.grad((states * w).sum(), [v for _, v in leaves])
        return states.detach(), grads

    got, got_g = run(towers._dot)
    want, want_g = run(rnn.bf16_matmul)
    err = (got - want).abs()
    check(bool(torch.isfinite(got).all()), "transformer states: not finite")
    check(float(err.max()) <= 2e-2, f"transformer states: max |tensor cores - bf16_matmul| "
          f"{float(err.max())} > 2e-2")
    rel = {name: float((g - h).abs().max() / h.abs().max().clamp_min(1e-12))
           for (name, _), g, h in zip(leaves, got_g, want_g)}
    worst = max(rel, key=rel.get)
    check(rel[worst] <= 3e-2, f"transformer gradient {worst}: {rel[worst]} of its max-abs > 3e-2")
    log(f"transformer tower B=256 (tensor cores vs bf16_matmul on the card): states max abs "
        f"{float(err.max()):.3g}, mean {float(err.mean()):.3g}, {int((err > 1e-3).sum())} of "
        f"{err.numel()} above 1e-3; gradients worst {worst} {rel[worst]:.3g} of max-abs "
        f"(autograd through _TensorCoreDot) [{card}]")
    with torch.no_grad():
        out = sse.encode_source({"src_tower": params}, cfg, tokens, lengths)
    check(bool(torch.isfinite(out).all()) and out.shape == (256, tower.encoding_dim),
          "transformer encode_source: shape or not finite")
    norm = torch.linalg.norm(out[lengths > 0], dim=1)  # a length-0 row is tanh(proj_b) = 0
    check(float((norm - 1).abs().max()) < 1e-3, "transformer encode_source: not unit norm")


def range_parts(run, names: dict, reps: int = 3) -> dict:
    """Device ms of one run() by part (torch.profiler with the CPU activity,
    after a warm run): the kernels launched by the ops inside the profiler
    range "chip.tower" are the tower; of the device's kernels and copies
    (device_times), each one whose name holds a pattern of ``names`` is
    that part (the hand-written kernels launch through ctypes, outside any
    op); the rest is "small ops"."""
    run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()

    def in_tower(e) -> bool:
        while e is not None:
            if e.name == "chip.tower":
                return True
            e = e.cpu_parent
        return False

    out = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and in_tower(e):
            out["tower"] += sum(k.duration for k in e.kernels if k.name != e.name
                                and not k.name.startswith(("sse.", "chip."))) / 1000.0 / reps
    times = {k: v / reps for k, v in device_times(prof).items()
             if not k.startswith(("sse.", "chip."))}
    for key, ms in times.items():
        part = next((p for pat, p in names.items() if pat in key), None)
        if part is not None:
            out[part] += ms
    out["batch"] = sum(times.values())
    out["small ops"] = out["batch"] - sum(v for k, v in out.items() if k != "batch")
    return dict(out)


def transformer_costs(card: str) -> None:
    """The transformer tower's forward (the recipe's model, random weights
    from the seed, no_grad, L=50, full lengths) at B=8, 256 and 4096: CUDA
    events around the call (at small B that is the host path), the
    kernels' device time (torch.profiler), the plain version's (the same
    tower on bf16_matmul, float32 CUDA-core products) at B=4096, the bound
    (its FLOPs over 989 TFLOP/s bf16; its bytes, tokens in and
    embeddings out, are far below), and the GEMM kernels' names, none of
    which may be a float32 or TF32 GEMM. Then one bulk B=4096 query batch
    (the engine's two-phase route on the 1,249,280-row bf16 index of
    unit rows, ragged lengths) by part: tower, phase 1, phase 2, select,
    small ops."""
    from torch.profiler import record_function

    from sse_tpu_torch.models import sse, towers
    from sse_tpu_torch.ops import rnn, topk
    from sse_tpu_torch.serve.engine import build_fused_query_fn

    cfg = transformer_config()
    tower = cfg.src_tower
    params = sse.init_params(cfg, torch.Generator().manual_seed(SEED))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    for b in (8, 256, 4096):
        tokens, lengths = tower_inputs(tower, b, gen)
        with torch.no_grad():
            run = lambda: sse.encode_source(params, cfg, tokens, lengths)  # noqa: E731
            ms = cuda_ms(run, reps=10)
            run()
            times = profiled(run, 5)
        device = NOT_MEASURED if times is None else sum(
            v for k, v in times.items() if not k.startswith("sse.")) / 5
        flops = transformer_flops(tower, b, 50)
        gemms = sorted(k for k in (times or {}) if any(g in k for g in GEMM))
        check(not [k for k in (times or {}) if any(f in k for f in FP32_GEMM)],
              f"transformer B={b}: a float32 GEMM ran: {sorted(times)}")
        line = (f"transformer tower forward B={b} L=50 ({tower.num_layers} blocks, d="
                f"{tower.hidden}): {ms:.4f} ms (CUDA events), device {device:.4f} ms; bound "
                f"{flops / PEAK['bf16'] * 1e3:.4f} ms ({flops / 1e9:.1f} GFLOP, operations)")
        if b == 4096:
            plain = lambda: towers._transformer_encode(  # noqa: E731
                params["src_tower"], tower, params["src_tower"]["embed"][tokens.long()],
                torch.ones((b, 50), device="cuda"), dot=rnn.bf16_matmul)
            with torch.no_grad():
                line += f"; plain body (bf16_matmul) {cuda_ms(plain, reps=3):.4f} ms"
        log(f"{line} [{card}]")
        log(f"transformer B={b} GEMM kernels (device ms per call): "
            + json.dumps({k[:110]: round(times[k] / 5, 4) for k in gemms}))
    tokens, _ = tower_inputs(tower, 4096, gen)
    lengths = torch.randint(1, 51, (4096,), generator=gen, device="cuda")
    emb = unit_rows(T_PAD, gen).bfloat16()
    nr, bt = T_PAD - 1000, topk.twophase_block_t(T_PAD, K)

    def batch():  # what build_fused_query_fn runs for a packed B >= 1024 batch
        with torch.no_grad():
            with record_function("chip.tower"):
                q = sse.encode_source(params, cfg, tokens, lengths)
            return topk.fused_score_topk_twophase(q, emb, K, nr, block_t=bt)

    fused = build_fused_query_fn(cfg, K)
    tok8, len8 = tokens[:8].contiguous(), lengths[:8].contiguous()
    ms8 = cuda_ms(lambda: fused(params, emb, tok8, len8, nr), reps=20)
    log(f"transformer query dispatch B=8 (build_fused_query_fn: tower + streaming top-k on the "
        f"1,249,280-row index; CUDA events, host path included): {ms8:.4f} ms [{card}]")
    split = range_parts(batch, TWOPHASE_PARTS)
    log(f"bulk transformer query batch B=4096 (two-phase route, device ms by part, "
        f"torch.profiler): {fmt(split)}; bound of the tower "
        f"{transformer_flops(tower, 4096, 50) / PEAK['bf16'] * 1e3:.4f} ms [{card}]")


# ------------------------------------------------------------ phase 7
SHARDED_MESHES = ((1, 2), (1, 4), (2, 2))
SHARDED_ROWS = 1_249_280  # the bench index's real rows, random unit rows
# where the two rank processes save their rows and index (beside this file)
MP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "sharded_mp")


def mesh_cards(n: int) -> list:
    """The cards of a grid of ``n`` entries: every entry cuda:0 on a
    one-card machine (the shards share the card), else the cards in turn."""
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def padded(shards: int) -> int:
    """The index rows of SHARDED_ROWS real rows in ``shards`` blocks
    (1,249,280; 1,253,376 at 2; 1,261,568 at 4)."""
    from sse_tpu_torch.index.sharded_index import _padded_rows

    return _padded_rows(SHARDED_ROWS, None, shards)


def sharded_rows(dtype) -> torch.Tensor:
    """SHARDED_ROWS random unit rows made on the card from a seeded
    generator (bench._device_index), stored as the index stores them, with
    zero padding to the 4-shard geometry: its first padded(1) rows are the
    unsharded index, its first padded(2) the 2-shard one."""
    from sse_tpu_torch import bench

    return bench._device_index(SHARDED_ROWS, D, dtype, "cuda", shards=4)


def sharded_tokens(b: int, seed: int, device="cuda"):
    """Seeded token ids and ragged lengths of a B=b batch at L=50."""
    from sse_tpu_torch import bench

    gen = torch.Generator(device=device).manual_seed(seed)
    toks = bench._random_tokens(gen, (b, 50), 8000, device)
    lens = torch.randint(1, 51, (b,), generator=gen, device=device, dtype=torch.int32)
    return toks, lens


def held_sharded(label: str, mesh, got, want, q_rep, q_full, emb, k: int, variant: str) -> str:
    """A sharded call's (vals, rows) against the unsharded call's on the
    same tokens. A grid of one data replica encodes the very batch the
    unsharded call encodes: rows and values must be identical. With
    several replicas each encodes its slice, and the GEMMs may round a
    slice's q apart from the whole batch's in the last bits: where a
    query's q matches, its rows must be identical to the unsharded call's;
    every query's must be identical to the unsharded top-k of its
    replica's own q (the engine's route for the whole batch, on the whole
    index), and a query whose q differs is also held against
    topk_reference (rows_off_reference)."""
    from sse_tpu_torch.ops import topk
    from sse_tpu_torch.serve.engine import _shard_topk

    (gv, gr), (wv, wr) = got, want
    if mesh.shape["data"] == 1:
        same(label, got, want)
        return "identical to the unsharded call"
    match = (q_rep == q_full).all(dim=1)
    check(torch.equal(gr[match], wr[match]) and torch.equal(gv[match], wv[match]),
          f"{label}: rows differ where the replica's q matches the whole batch's")
    comp = _shard_topk(q_rep, emb, k, SHARDED_ROWS, 0, variant)
    same(f"{label} on the replicas' q", got,
         topk.decode(comp, emb.dtype == torch.int8, variant == "exact"))
    n = 0
    if not bool(match.all()):
        n = rows_near_reference(q_rep[~match], emb, SHARDED_ROWS, gr[~match], variant)
    return (f"identical where q matches the whole batch's ({int(match.sum())} of {len(match)} "
            f"queries), identical to the unsharded top-k of the replicas' q; "
            f"{n} positions apart from topk_reference where q differs, each within tolerance")


def sharded_slice(card: str) -> dict:
    """Sharded serving (``sse_tpu_torch.parallel``) on the bench's GRU
    model and a 1,249,280-row index of random unit rows: the (1, 2),
    (1, 4) and (2, 2) grids' captured functions (one CUDA graph a
    distinct card) against the unsharded fused query (bf16 and int8, B=8
    streaming and B=4096 two-phase a shard, k=10 and 100; the exact
    variant at B=8): a replay equals the eager grid call (``.run``) bit
    for bit with no host sync, and its launches are one a shard and
    kernel (data x model); the grids' and the unsharded call's ms a call,
    replayed and eager, and each card's busy share at B=8 and 4096
    (sharded_timing); the bench's query setup on a grid; a (2, 2) engine
    served over HTTP (GET, POST of 4,096 texts, /api/stats) held against
    topk_reference on the whole index; an add and a delete across a shard
    boundary on a (1, 2) engine against the same on one device; two
    processes joined by parallel.distributed (sharded_processes); and the
    grid index build (sharded_build). Returns the launch counts of the
    HTTP run (reset just before it)."""
    from sse_tpu_torch import bench, ops
    from sse_tpu_torch.models import sse
    from sse_tpu_torch.parallel import RowShards, make_mesh, replicate
    from sse_tpu_torch.serve.engine import build_fused_query_fn

    t0 = time.perf_counter()
    count = torch.cuda.device_count()
    where = ("every grid entry is cuda:0: the shards share one card and their launches run "
             "one after another" if count == 1 else
             f"{count} cards: grid entry i is cuda:(i mod {count})")
    log(f"sharded: {where}")
    cfg = bench._default_model()
    params = sse.init_params(cfg, torch.Generator().manual_seed(SEED), "cuda")
    meshes = {shape: make_mesh(*shape, devices=mesh_cards(shape[0] * shape[1]))
              for shape in SHARDED_MESHES}
    for shape, mesh in meshes.items():
        check(mesh.shape == {"data": shape[0], "model": shape[1]}, f"mesh {mesh.shape}")
    reps = {shape: replicate(params, mesh) for shape, mesh in meshes.items()}
    timings = []
    for dtype in (torch.bfloat16, torch.int8):
        base = sharded_rows(dtype)
        full = base[:SHARDED_ROWS]
        shards = {shape: RowShards.from_tensor(base[:padded(shape[1])], mesh)
                  for shape, mesh in meshes.items()}
        geometry = {s: shards[(1, s)].rows_per_shard for s in (2, 4)}
        check(all(t % ops.topk.TWOPHASE_BLOCK_T == 0 for t in geometry.values()),
              f"shard rows {geometry} not whole two-phase blocks")
        log(f"sharded {str(dtype)[6:]} index: {SHARDED_ROWS} rows; {padded(2)} rows in 2 shards "
            f"and {padded(4)} in 4, rows a shard {geometry}")
        for b, k, variant in ((8, 10, "packed"), (8, 100, "packed"), (4096, 10, "packed"),
                              (4096, 100, "packed"), (8, 10, "exact")):
            toks, lens = sharded_tokens(b, 100 + b + k)
            unsharded = build_fused_query_fn(cfg, k, SHARDED_ROWS, variant)
            want = unsharded(params, full, toks, lens)
            with torch.no_grad():
                q_full = sse.encode_source(params, cfg, toks, lens)
            for shape, mesh in meshes.items():
                label = f"{shape} {dtype} B={b} k={k} {variant}"
                fn = build_fused_query_fn(cfg, k, SHARDED_ROWS, variant, mesh=mesh)
                cards = mesh.entries_by_device()
                first = fn(reps[shape], shards[shape], toks, lens)  # a capture a distinct card
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                torch.cuda.set_sync_debug_mode("error")  # no host sync from the copies in on
                try:
                    got = fn(reps[shape], shards[shape], toks, lens)  # every card, then the merge
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
                counts = ops.launch_counts()
                eager = uncounted(lambda: fn.run(reps[shape], shards[shape], toks, lens,
                                                 SHARDED_ROWS))
                same(f"{label}: replay against eager", got, eager)
                same(f"{label}: the capture's warm-up against eager", first, eager)
                check(fn.stats.counts() == {"graph_captures": len(cards),
                                            "graph_replays": len(cards), "graph_eager": 0},
                      f"{label}: {fn.stats.counts()} for {len(cards)} distinct cards")
                data, s = shape
                two = (variant == "packed" and b // data >= ops.topk.TWOPHASE_MIN_BATCH
                       and ops.topk.twophase_block_t(shards[shape].rows_per_shard, k) is not None)
                names = (("twophase_p1", "twophase_p2") if two else
                         ("topk_exact",) if variant == "exact" else ("topk_stream",))
                check(all(counts[n] == data * s for n in names)
                      and sum(counts[n] for n in ops.topk.KERNELS) == len(names) * data * s
                      and counts["gru_fwd"] == sum(len(set(mesh.devices[d].tolist()))
                                                   for d in range(data)),
                      f"{shape} B={b}: launches {counts}, want {data * s} of {names}")
                bl = b // data
                with torch.no_grad():
                    q_rep = torch.cat([sse.encode_source(params, cfg, toks[d * bl:(d + 1) * bl],
                                                         lens[d * bl:(d + 1) * bl])
                                       for d in range(data)])
                how = held_sharded(label, mesh, got, want, q_rep, q_full, full, k, variant)
                log(f"sharded {shape} {str(dtype)[6:]} B={b} k={k} {variant}: one graph on each "
                    f"of {len(cards)} distinct cards, a replay == eager bit for bit with no host "
                    f"sync; launches a replay {({n: counts[n] for n in names})} ({data * s} a "
                    f"kernel), gru_fwd {counts['gru_fwd']}; rows {how}")
                if dtype == torch.bfloat16 and k == 10 and variant == "packed":
                    timings.append((shape, b, fn, reps[shape], shards[shape], toks, lens))
            if dtype == torch.bfloat16 and k == 10 and variant == "packed":
                timings.append(((1, 1), b, unsharded, params, full, toks, lens))
        if dtype == torch.bfloat16:
            for shape, b, fn, p, emb, toks, lens in sorted(timings, key=lambda t: (t[1], t[0])):
                sharded_timing(card, where if shape != (1, 1) else "one card, unsharded",
                               shape, b, fn, p, emb, toks, lens)
            timings.clear()
            s = bench.query_setup(num_targets=SHARDED_ROWS, encoding_dim=D, batch=8, k=K,
                                  index_dtype=torch.bfloat16, mesh=meshes[(1, 2)])
            result = bench.time_query(s, 0.5)
            vals, rows, n, bad = bench.first_batch(s)
            check(not bad and result["value"] > 0, f"bench on a grid: {result}, {bad[:5]}")
            log(f"sharded bench query (1, 2) bf16 B=8: {json.dumps(result)}; first batch "
                f"against topk_reference: {n} positions apart, each within tolerance [{card}]")
            del s
        del base, full, shards
        torch.cuda.empty_cache()

    counts = sharded_engines(cfg, params, meshes)
    sharded_processes(cfg, params)
    sharded_build(card, meshes)
    log(f"sharded slice: {time.perf_counter() - t0:.1f} s")
    return counts


def card_busy(calls, window: int = 32) -> tuple:
    """Wall ms of ``window`` calls (``calls``: functions run in turn)
    ending in a drain, under torch.profiler, and each card's busy ms in
    it (the union of its kernels' and copies' spans on the device
    timeline): (wall, {card index: busy ms}), busy NOT_MEASURED where the
    session saw no device event."""
    calls[0]()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(window):
            calls[i % len(calls)]()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = collections.defaultdict(list)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.time_range.end > ev.time_range.start:
            spans[ev.device_index].append((ev.time_range.start, ev.time_range.end))
    busy = {}
    for dev, ranges in spans.items():
        total, end = 0.0, -math.inf
        for a, b in sorted(ranges):
            if b > end:
                total += b - max(a, end)
                end = b
        busy[dev] = total / 1e3
    if not busy:
        warn("torch.profiler saw no device event in a window of grid calls: busy not measured")
        busy = {torch.cuda.current_device(): NOT_MEASURED}
    return wall, busy


def sharded_timing(card: str, where: str, shape, b: int, fn, p, emb, toks, lens) -> None:
    """One grid function (or the unsharded one, shape (1, 1)) at B=b:
    replayed and eager (``fn.run``), ms a call by CUDA events, device ms
    a call (torch.profiler: kernels and copies summed over the cards), and
    each card's busy share of a window of 32 calls on random tokens."""
    from sse_tpu_torch import bench

    gen = torch.Generator(device="cuda").manual_seed(200 + b)
    variants = [bench._random_tokens(gen, (b, 50), 8000, "cuda") for _ in range(4)]
    full = torch.full((b,), 50, dtype=torch.int32, device="cuda")
    parts = []
    for how, call in (("replayed", lambda t, l: fn(p, emb, t, l)),
                      ("eager", lambda t, l: fn.run(p, emb, t, l, SHARDED_ROWS))):
        def measure():
            run = lambda: call(toks, lens)  # noqa: E731
            times = profiled(run, 3)
            dev = NOT_MEASURED if times is None else sum(times.values()) / 3
            ms = cuda_ms(run, 5)
            wall, busy = card_busy([lambda v=v: call(v, full) for v in variants])
            return dev, ms, wall, busy

        dev, ms, wall, busy = measure() if how == "replayed" else uncounted(measure)
        shares = ", ".join(f"cuda:{i} {100.0 * t / wall:.1f}%" for i, t in sorted(busy.items()))
        parts.append(f"{how} {ms:.4f} ms a call (CUDA events), device {dev:.4f} ms a call "
                     f"(torch.profiler, summed over the cards), a window of 32: {wall:.3f} ms, "
                     f"busy {shares}")
    log(f"sharded timing {shape} bf16 B={b} k=10: " + "; ".join(parts) + f" -- {where}"
        f"{'; not a multi-card speed' if torch.cuda.device_count() == 1 else ''} [{card}]")


def sharded_build(card: str, meshes) -> None:
    """build_index (the bench's GRU tower, bf16, EVAL_ROWS random target
    texts, 64 x 256-row chunks) on the (1, 2) and (1, 4) grids against the
    one-card build: the grid's rows equal the one card's bit for bit, the
    padding rows zero, one capture a card that encodes a chunk, JAX's
    progress calls; docs/s replayed and eager beside the one card's."""
    from sse_tpu_torch.index import build_index
    from sse_tpu_torch.utils.graphs import GraphStats

    cfg, params = graph_model("gru")
    tspace, _ = eval_data(EVAL_ROWS, 1)
    t = tspace.num_targets
    kw = dict(batch_size=256, dtype=torch.bfloat16, chunk_batches=64)
    one, one_s = synced_s(lambda: build_index(params, cfg, tspace, **kw))
    _, one_eager_s = uncounted(lambda: synced_s(
        lambda: build_index(params, cfg, tspace, capture=False, **kw)))
    want = [(min(hi, t), t) for hi in range(16384, t + 16384, 16384)]
    for shape in ((1, 2), (1, 4)):
        mesh = meshes[shape]
        stats, calls = GraphStats(), []
        grid, s = synced_s(lambda: build_index(params, cfg, tspace, mesh=mesh, graph_stats=stats,
                                               progress=lambda *a: calls.append(a), **kw))
        eager, eager_s = uncounted(lambda: synced_s(
            lambda: build_index(params, cfg, tspace, mesh=mesh, capture=False, **kw)))
        rows = grid.emb[:]
        check(torch.equal(rows[:t], one.emb[:t]) and not rows[t:].any(),
              f"grid build {shape}: rows != the one-card build's")
        check(torch.equal(rows, eager.emb[:]), f"grid build {shape}: replayed != eager")
        t_local = grid.emb.rows_per_shard
        used = {mesh.column_devices(lo // t_local)[0] for lo in range(0, t, 16384)}
        chunks = len(want)
        check(calls == want and stats.counts() == {"graph_captures": len(used),
                                                   "graph_replays": chunks - len(used),
                                                   "graph_eager": 0},
              f"grid build {shape}: {stats.counts()}, progress {calls[:3]}...")
        log(f"sharded build {shape} ({t:,} targets, bf16, {chunks} chunks of 64 x 256): rows == "
            f"the one-card build's bit for bit, padding zero; {len(used)} captures ("
            + ", ".join(f"{g['seconds']:.3f} s {g['mib']:.1f} MiB" for g in stats.log)
            + f"), {stats.counts()['graph_replays']} replays; {s:.2f} s ({t / s:,.0f} docs/s, "
            f"the captures included) against eager {eager_s:.2f} s ({t / eager_s:,.0f} docs/s); "
            f"one card {one_s:.2f} s ({t / one_s:,.0f} docs/s), eager {one_eager_s:.2f} s "
            f"({t / one_eager_s:,.0f} docs/s) [{card}]")
        del grid, eager, rows
        torch.cuda.empty_cache()


def sharded_engines(cfg, params, meshes) -> dict:
    """A (2, 2) engine over the bf16 index served over HTTP, and an add
    and a delete across a shard boundary on a (1, 2) engine (see
    sharded_slice), with the ranking demo corpus' vocabulary and eval
    texts. Returns the HTTP run's launch counts."""
    from sse_tpu_torch import ops
    from sse_tpu_torch.data import synthetic
    from sse_tpu_torch.data.corpus import build_vocab
    from sse_tpu_torch.index import ShardedIndex
    from sse_tpu_torch.models import sse
    from sse_tpu_torch.parallel import RowShards
    from sse_tpu_torch.serve import QueryEngine, serve_http

    train, evalp, targets = synthetic.make_corpus(task="ranking", num_targets=1024, seed=SEED)
    vocab = build_vocab(8000, train, targets)
    base = sharded_rows(torch.bfloat16)
    ids = [f"r{i}" for i in range(SHARDED_ROWS)]
    mesh = meshes[(2, 2)]
    index = ShardedIndex(emb=RowShards.from_tensor(base[:padded(2)], mesh),
                         num_real=SHARDED_ROWS, ids=ids, texts=ids, mesh=mesh)
    engine = QueryEngine(params, cfg, vocab, index, max_seq_length=50, max_batch=8, k=K,
                         bulk_batch=4096)
    warm_s = engine.warmup()
    cards = len(mesh.entries_by_device())
    shapes = len(engine._batch_tiers()) * len(engine._bucket_widths())
    check(engine.captures_graphs and engine.graph_counts() == {
        "graph_captures": shapes * cards, "graph_replays": 0, "graph_eager": 0,
        "graphs_cached": shapes * cards},
          f"sharded (2, 2) warmup: {engine.graph_counts()}, want {shapes} x {cards} captures")
    log(f"sharded (2, 2) engine warmup: {warm_s:.2f} s, {shapes * cards} captures ({shapes} "
        f"shapes x {cards} distinct cards): "
        + ", ".join(f"{g['shape']} {g['card']} {g['seconds']:.3f} s {g['mib']:.1f} MiB"
                    for g in engine.last_warmup["graphs"]))
    texts = [s for s, _ in evalp[:4096]]
    check(len(texts) == 4096, "4,096 eval texts")
    ops.reset_launch_counts()
    server = serve_http(engine, port=free_port(), block=False)
    base_url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        got = http_json(base_url + "/api/query?keywords=" + urllib.request.quote(texts[0]))
        t0 = time.perf_counter()
        bulk = http_json(base_url + "/api/query", {"queries": texts})["results"]
        log(f"sharded (2, 2) POST /api/query with 4096 texts: {time.perf_counter() - t0:.3f} s")
        stats = http_json(base_url + "/api/stats")
    finally:
        server.shutdown()
        server.server_close()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    BATCH_LAUNCHES.update(ops.topk.launches)
    log(f"sharded (2, 2) served run launches: {counts}, top-k by batch size "
        f"{dict(ops.topk.launches)}")
    check(len(bulk) == 4096 and all(len(h) == K for h in bulk) and len(got["results"]) == K,
          "sharded served result shapes")
    check(stats["graph_captures"] == shapes * cards == stats["graphs_cached"]
          and stats["graph_replays"] >= 2 * cards and stats["graph_replays"] % cards == 0,
          f"sharded (2, 2) /api/stats: {stats}")
    log(f"sharded (2, 2) /api/stats: graph_captures {stats['graph_captures']}, graph_replays "
        f"{stats['graph_replays']} ({cards} a dispatch), graphs_cached {stats['graphs_cached']}")
    full = base[:SHARDED_ROWS]
    for name, tx, res in (("GET", texts[:1], [got["results"]]), ("POST", texts, bulk)):
        tokens, lengths = engine.encode_queries(tx)
        bl = tokens.shape[0] // 2
        with torch.no_grad():  # each replica's own q, as the engine encoded it
            q = torch.cat([sse.encode_source(params, cfg, tokens[d * bl:(d + 1) * bl],
                                             lengths[d * bl:(d + 1) * bl]) for d in range(2)])
        rows = torch.tensor([[h["row"] for h in hits] for hits in res], device="cuda")
        n = rows_near_reference(q[: len(tx)], full, SHARDED_ROWS, rows)
        log(f"sharded (2, 2) served {name} of {len(tx)}: rows == topk_reference on the whole "
            f"index ({n} positions apart, each within one key bucket)")

    # add across the boundary between the two blocks of a (1, 2) index
    # holding 5 rows less than its first block, then delete rows of both
    # blocks; the same on one device; the next queries must agree bit for
    # bit
    edge = padded(2) // 2
    nr = edge - 5
    m12 = meshes[(1, 2)]
    one = ShardedIndex(emb=base[:padded(2)].clone(), num_real=nr, ids=ids[:nr], texts=ids[:nr])
    two = ShardedIndex(emb=RowShards.from_tensor(base[:padded(2)], m12), num_real=nr,
                       ids=ids[:nr], texts=ids[:nr], mesh=m12)
    engines = [QueryEngine(params, cfg, vocab, ix, max_seq_length=50, max_batch=8, k=K)
               for ix in (two, one)]
    for e in engines:
        e.warmup()
    grid = engines[0]
    cards = len(m12.entries_by_device())
    shapes = len(grid._bucket_widths())
    new = [f"new{i}" for i in range(10)]
    gone = ["r5", "new9", f"r{edge - 600}", "new2", f"r{edge // 2}"]
    for e in engines:
        check(e.add_documents(new, texts[:10]) == nr + 10, "add")
    check(grid.graph_counts()["graph_captures"] == shapes * cards,
          f"the add across the blocks captured: {grid.graph_counts()}")
    a, b = (e.query(texts[:8]) for e in engines)
    check(a == b, "queries after the add differ between the grid and one device")
    old_emb, old_nr = two.pub[:2]
    for e in engines:
        check(e.delete_documents(gone) == nr + 5, "delete")
    check(grid.graph_counts()["graph_captures"] == 2 * shapes * cards
          and grid.last_warmup["captures"] == shapes * cards,
          f"the delete's warmup: {grid.graph_counts()}, {grid.last_warmup['captures']}")
    fn = grid._fused
    tokens, lengths = grid.encode_queries(texts[:8])
    stale = fn(grid.params, old_emb, tokens, lengths, old_nr)  # the replaced RowShards
    same("a call on the replaced RowShards against eager", stale,
         uncounted(lambda: fn.run(grid.params, old_emb, tokens, lengths, old_nr)))
    check(grid.graph_counts()["graph_captures"] == 2 * shapes * cards
          and grid.graph_counts()["graphs_cached"] == shapes * cards,
          f"a call on the replaced RowShards captured or dropped: {grid.graph_counts()}")
    check(torch.equal(two.emb[:], one.emb), "sharded add/delete rows != one device's")
    check(two.ids == one.ids, "sharded add/delete ids != one device's")
    a, b = (e.query(texts[:8]) for e in engines)
    check(a == b, "queries after add/delete differ between the grid and one device")
    log(f"sharded (1, 2) add of 10 across row {edge}: no capture; delete of 5 from both shards: "
        f"{shapes * cards} captures, all through its warmup; a call on the replaced RowShards "
        f"ran eagerly (== eager) and dropped nothing; rows, ids and the next 8 queries == one "
        f"device's")
    return counts


def sharded_processes(cfg, params) -> None:
    """Two processes (``python3 chip_smoke.py --sharded-rank R``) joined by
    parallel.distributed.initialize over the card(s) (gloo when they share
    one, NCCL on two), each holding one block of a (1, 2) grid: both ranks'
    sharded rows at B=8 and 4096 must be the single process's unsharded
    rows, and the index they save, each its own block, must load in this
    process with the same rows and answer the same queries."""
    import shutil

    from sse_tpu_torch.index import ShardedIndex
    from sse_tpu_torch.serve.engine import build_fused_query_fn

    shutil.rmtree(MP_DIR, ignore_errors=True)
    coord = f"127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    # the kernels are built (main) before the ranks start: they load the
    # same library instead of racing two nvcc runs into one directory
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sharded-rank",
                               str(r), coord],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"rank {r} failed ({p.returncode}):\n{out}\n{err}")
        for line in (out + err).splitlines():
            if line.startswith("[sse]") or line.startswith("rank"):
                log(f"  rank {r}: {line}")
    log(f"sharded processes: both ranks done in {time.perf_counter() - t0:.1f} s")
    full = sharded_rows(torch.bfloat16)
    loaded = ShardedIndex.load(os.path.join(MP_DIR, "index"), "cuda")
    check(loaded.num_real == SHARDED_ROWS and torch.equal(loaded.emb, full[:padded(2)])
          and loaded.ids == [f"r{i}" for i in range(SHARDED_ROWS)],
          "the two-process save loaded back other rows")
    for b in (8, 4096):
        toks, lens = sharded_tokens(b, 7 + b)
        fn = build_fused_query_fn(cfg, K, SHARDED_ROWS)
        want = fn(params, full[:SHARDED_ROWS], toks, lens)
        same(f"two-process save, loaded, B={b}", fn(params, loaded.emb, toks, lens), want)
        for r in range(2):
            got = torch.load(os.path.join(MP_DIR, f"rank{r}_b{b}.pt"))
            same(f"rank {r} B={b}", (got[0].cuda(), got[1].cuda()), want)
    log("sharded processes: both ranks' rows at B=8 and 4096 == the single process's; the "
        "two-process save loads back with the same rows and answers")


def sharded_rank(rank: int, coord: str) -> None:
    """One rank of sharded_processes."""
    from sse_tpu_torch import bench
    from sse_tpu_torch.index import ShardedIndex
    from sse_tpu_torch.models import sse
    from sse_tpu_torch.parallel import RowShards, distributed, make_mesh
    from sse_tpu_torch.serve.engine import build_fused_query_fn

    distributed.initialize(coord, 2, rank)
    dev = distributed.local_device()
    mesh = make_mesh(1, 2)
    check(mesh.multi_process and mesh.ranks.tolist() == [[0, 1]], f"rank {rank}: {mesh}")
    cfg = bench._default_model()
    params = sse.init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    rows = bench._device_index(SHARDED_ROWS, D, torch.bfloat16, dev, shards=2)
    ids = [f"r{i}" for i in range(SHARDED_ROWS)]
    index = ShardedIndex(emb=RowShards.from_tensor(rows, mesh), num_real=SHARDED_ROWS, ids=ids,
                         texts=ids, mesh=mesh)
    del rows
    fn = build_fused_query_fn(cfg, K, SHARDED_ROWS, mesh=mesh)
    os.makedirs(MP_DIR, exist_ok=True)
    for b in (8, 4096):
        toks, lens = sharded_tokens(b, 7 + b, dev)
        vals, got = fn(params, index.emb, toks, lens)
        torch.save((vals.cpu(), got.cpu()), os.path.join(MP_DIR, f"rank{rank}_b{b}.pt"))
    index.save(os.path.join(MP_DIR, "index"))
    print(f"rank {rank}: {distributed.process_info()}, backend {distributed.backend()}",
          flush=True)
    torch.distributed.destroy_process_group()


# ------------------------------------------------- training on a grid
GRID_STEPS = 8
GRID_TABLE = 1_249_280  # the classification preset's table at the query bench's index size
CP_SHAPE = (256, 512)  # B, L of the context-parallel encode
MP_TRAIN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "grid_mp")

# Runs ``python -m sse_tpu_torch.cli <args>``; where the run trains on a
# grid and SMOKE_SHADOW=1, it holds every step against the one-card step
# from the same state (recording_steps(shadow=True)); it prints the sums of
# its final inference params (every rank's own) and how many steps were
# held.
MP_RUNNER = (
    "import json, os, runpy, sys\n"
    "import chip_smoke\n"
    "import sse_tpu_torch.workspace as w\n"
    "from sse_tpu_torch.train import inference_params, loop\n"
    "steps = []\n"
    "chip_smoke.recording_steps(steps, shadow=os.environ.get('SMOKE_SHADOW') == '1')\n"
    "real = w.train_loop\n"
    "def train(*a, **k):\n"
    "    s = real(*a, **k)\n"
    "    leaves = loop.tree_leaves(inference_params(s))\n"
    "    print('[params] ' + json.dumps([float(sum(x.double().sum() for x in leaves)),\n"
    "          float(sum(x.double().abs().sum() for x in leaves))]), flush=True)\n"
    "    print('[chains] ' + json.dumps(chip_smoke.CHAIN_CHECKS), flush=True)\n"
    "    held = [r[4] for r in steps if r[4] is not None]\n"
    "    print('[held] ' + json.dumps([len(steps), len(held), max([h[0] for h in held] or [0]),\n"
    "          sum(h[1] for h in held), max([h[2] for h in held] or [0]),\n"
    "          max([h[3] for h in held] or [0])]), flush=True)\n"
    "    return s\n"
    "w.train_loop = train\n"
    "sys.argv = ['sse_tpu_torch.cli', *sys.argv[1:]]\n"
    "runpy.run_module('sse_tpu_torch.cli', run_name='__main__', alter_sys=True)\n"
)


# what recording_steps found of each captured grid chain it held against
# its eager steps: "bit for bit", or held_state's reading
CHAIN_CHECKS: list = []


def recording_steps(records: list, shadow: bool = False):
    """Patch loop.make_train_step so that every step it builds appends
    (loss, grad_norm, host ms, the recurrent kernels it launched, and with
    ``shadow`` what shadow_step found and every kernel the shadow step
    launched) to ``records``; a chain it builds runs its steps one by one,
    each recorded and shadowed as a step. With ``shadow`` on a grid whose
    chain is captured (a single-process grid of cards, or ranks over
    NCCL), the captured chain then replays the chunk from the same state,
    is held against those steps (bit for bit where they agree, else as
    held_state holds a state; CHAIN_CHECKS) and gives the result.
    Returns the undo."""
    from sse_tpu_torch import ops
    from sse_tpu_torch.train import grid, loop

    real = loop.make_train_step

    def make(*args, chain: int = 1, **kw):
        step = real(*args, **kw)
        plain = real(*args, **{**kw, "mesh": None}) if shadow and kw.get("mesh") else None

        def run(state, *a, **k):
            before = ops.launch_counts()
            t0 = time.perf_counter()
            new, m = step(state, *a, **k)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1000.0
            after = ops.launch_counts()
            held = shadow_step(plain, state, new, m, a, k, len(records) + 1) if plain else None
            shadow = {n: c - after[n] for n, c in ops.launch_counts().items()}
            records.append((float(m["loss"]), float(m["grad_norm"]), ms,
                            {n: after[n] - before[n] for n in RNN_KERNELS}, held, shadow))
            return new, m

        if chain <= 1:
            return run
        steps = loop._eager_chain(run, chain)
        captured = real(*args, chain=chain, **kw) if shadow and kw.get("mesh") else None
        if not hasattr(captured, "chains"):  # an eager chain: its steps are the ones above
            captured = None

        def chained(state, packed_k, *a, **k):
            lead = state.mesh.local_devices[0] if state.mesh is not None else \
                loop.tree_leaves(state.params)[0].device
            new, m = steps(state, packed_k.to(lead), *a, **k)  # a chunk may come pinned
            if captured is None:
                return new, m
            want, wm = grid_state_copy(new), {n: v.clone() for n, v in m.items()}
            got, gm = captured(state, packed_k, *a, **k)
            leaves = grid.state_tensors
            if all(torch.equal(x, y) for x, y in zip(leaves(got), leaves(want))) and all(
                    torch.equal(gm[n], wm[n]) for n in wm):
                CHAIN_CHECKS.append("bit for bit")
            else:
                CHAIN_CHECKS.append(held_state(f"chain at step {state.step}",
                                               grid.gather_state(got), grid.gather_state(want)))
            return got, gm

        return chained

    loop.make_train_step = make
    return lambda: setattr(loop, "make_train_step", real)


def shadow_step(plain, state, new, m, args, kw, i: int) -> float:
    """The one-card step from the grid step's own input state (gathered
    whole, the table assembled) on the same batch, against the grid step:
    loss and grad_norm within rtol 2e-4, the new state as held_state holds
    it. Returns held_state's reading."""
    from sse_tpu_torch.parallel.mesh import Replicated
    from sse_tpu_torch.train.grid import copies_identical, gather_state

    lead = state.mesh.local_devices[0]
    on = lambda x: x[lead] if isinstance(x, Replicated) else x  # noqa: E731
    args = [on(x) for x in args]
    if state.mesh.multi_process:  # the one-card step takes the global batch: every rank's rows
        from sse_tpu_torch.parallel import distributed

        args[0] = distributed.all_gather(args[0]).flatten(0, 1)
    ref, rm = plain(gather_state(state), *args, **{k: on(v) for k, v in kw.items()})
    for key in ("loss", "grad_norm"):
        g, r = float(m[key]), float(rm[key])
        check(abs(g - r) <= 2e-4 * abs(r), f"grid step {i} from the same state: {key} {g} "
                                            f"against one card's {r}")
    held = held_state(f"grid step {i}", gather_state(new), ref)
    check(copies_identical(new), f"grid step {i}: the replicas' copies differ")
    return held


# The largest share of a leaf's elements that held_params may leave out
# (PERF.md §6 gives the readings it was set from).
SKIP_SHARE = 1e-3


def held_params(label: str, got, want, nu=None) -> tuple:
    """Each leaf of ``got`` (a state's tree, whole) within rtol 3e-3 / atol
    3e-5 of ``want``'s. With ``nu`` (the reference's Adam second moment,
    bias-corrected) an element whose sqrt(nu) is under 2^-6 of its leaf's
    largest may fail, at most SKIP_SHARE of the leaf: there the Adam
    update m / (sqrt(nu) + eps) divides a gradient's rounding noise by its
    own size. That noise is a bf16 rounding: the card's bf16 cotangents
    (the one rounding point where its products differ from
    ``bf16_matmul``, ROADMAP §3) turn a 1e-7 change upstream into 2^-8 of
    an element, and a weight that a bf16 product reads inside a tower gets
    its gradient rounded a replica (2^-9 of each part, train/grid.py).
    Returns (the largest |difference| held, the elements left out, the
    largest share of a leaf left out)."""
    from sse_tpu_torch.train import loop

    worst, skipped, share = 0.0, 0, 0.0
    if want is None:
        check(got is None, f"{label}: present where the reference has none")
        return worst, skipped, share
    scales = [None] * len(loop.tree_leaves(want)) if nu is None else loop.tree_leaves(nu)
    for a, b, v in zip(loop.tree_leaves(got), loop.tree_leaves(want), scales):
        d = (a.to(b.device) - b).abs()
        bad = d > 3e-5 + 3e-3 * b.abs()
        if v is not None:
            rms = v.sqrt()
            noisy = rms < 2.0**-6 * rms.max()
            n_out = int((bad & noisy).sum())
            check(n_out <= SKIP_SHARE * b.numel(),
                  f"{label}: {n_out} of {b.numel()} elements of a {tuple(b.shape)} leaf where "
                  f"Adam's update is not conditioned beyond rtol 3e-3 / atol 3e-5, more than "
                  f"{SKIP_SHARE:g} of the leaf")
            skipped += n_out
            share = max(share, n_out / b.numel())
            bad &= ~noisy
            d = torch.where(noisy, torch.zeros_like(d), d)
        n = int(bad.sum())
        check(n == 0, f"{label}: {n} of {b.numel()} elements of a {tuple(b.shape)} leaf beyond "
                      f"rtol 3e-3 / atol 3e-5 (max |d| {float(d.max()):.3g})")
        worst = max(worst, float(d.max()))
    return worst, skipped, share


def held_moments(label: str, got, ref) -> float:
    """Adam's moments of a state against the reference's: the first and
    sqrt of the second (each in the units of a gradient), each leaf within
    3e-3 of the reference leaf in the 2-norm, and the first also element
    by element within rtol 3e-3 / atol 3e-5. Returns the largest relative
    2-norm difference."""
    from sse_tpu_torch.train import loop

    held_params(f"{label} Adam first moment", got.mu, ref.mu)
    worst = 0.0
    for name, g, r in (("first", got.mu, ref.mu),
                       ("sqrt of the second", loop.tree_map(torch.sqrt, got.nu),
                        loop.tree_map(torch.sqrt, ref.nu))):
        for a, b in zip(loop.tree_leaves(g), loop.tree_leaves(r)):
            rel = float(torch.linalg.vector_norm(a.to(b.device) - b)) / max(
                float(torch.linalg.vector_norm(b)), 1e-30)
            check(rel <= 3e-3, f"{label}: Adam's {name} moment of a {tuple(b.shape)} leaf "
                               f"{rel:.3g} from the reference's in the 2-norm (relative)")
            worst = max(worst, rel)
    return worst


def held_state(label: str, got, ref) -> tuple:
    """A state (whole) against the reference state: Adam's moments as
    held_moments holds them; the params and EMA within rtol 3e-3 / atol
    3e-5 where Adam's update is conditioned (held_params). Returns (the
    largest |difference| of the params, the elements left out, the
    largest share of a leaf left out, the moments' largest relative
    difference)."""
    from sse_tpu_torch.train import loop

    opt = ref.opt_state
    nu, moments = None, 0.0
    if opt is not None:
        moments = held_moments(label, got.opt_state, opt)
        c2 = float(1.0 - np.power(np.float32(0.999), np.float32(int(opt.count))))
        nu = loop.tree_map(lambda v: v / c2, opt.nu)
    worst, skipped, share = held_params(f"{label} params", got.params, ref.params, nu)
    _, more, ema_share = held_params(f"{label} EMA", got.ema_params, ref.ema_params, nu)
    return worst, skipped + more, max(share, ema_share), moments


def grid_split(label: str, run, card: str, reps: int = 3) -> dict:
    """A grid step's device time by part (step_split over ``reps`` steps of
    ``run()``): forward, backward, the gradient sum over 'data', the
    update and, with a sharded table, the cross-block combine; the wall ms
    and the device-busy share. Returns the split (ms a step by range)."""
    run()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1000.0 / reps
    busy = sum(v for k, v in device_times(prof).items() if not k.startswith("sse.")) / reps
    split, _ = step_split(prof)
    split = {k[:60]: round(v / reps, 4) for k, v in sorted(split.items(), key=lambda kv: -kv[1])}
    log(f"{label} split (torch.profiler, {reps} steps, ms a step): wall {wall:.4f}, device busy "
        f"{busy:.4f} ({100.0 * busy / wall:.1f}%); by range (step_split): {json.dumps(split)} "
        f"[{card}]")
    return split


def flagship_problem(steps: int = GRID_STEPS, b: int = 256, t: int = 4096, length: int = 50):
    """The ranking preset at its widths (GRU, E=H=D=128, vocab 8000, dual
    encoder, 128 sampled and 16 mined negatives, Adam, EMA 0.999) at the
    train bench's B=256: ``steps`` batches of seeded pairs (a quarter of
    them with a second label), ``t`` targets of ragged lengths up to L=50,
    the hard-negative cache refreshed every 4 steps."""
    from sse_tpu_torch import configs
    from sse_tpu_torch.data.corpus import EncodedPairs, TargetSpace

    rng = np.random.default_rng(SEED)
    n = steps * b
    labels = rng.integers(0, t, size=n).astype(np.int32)
    lm = np.full((n, 2), -1, np.int32)
    lm[:, 0] = labels
    take = rng.random(n) < 0.25
    lm[take, 1] = rng.integers(0, t, size=n)[take]
    pairs = EncodedPairs(src=rng.integers(2, 8000, size=(n, length)).astype(np.int32),
                         src_len=rng.integers(1, length + 1, size=n).astype(np.int32),
                         labels=labels, label_sets=[(int(x),) for x in labels], labels_multi=lm)
    tspace = TargetSpace(ids=[f"t{i}" for i in range(t)], texts=["x"] * t,
                         tokens=rng.integers(2, 8000, size=(t, length)).astype(np.int32),
                         lengths=rng.integers(1, length + 1, size=t).astype(np.int32),
                         id_to_row={f"t{i}": i for i in range(t)})
    task = configs.preset("ranking", batch_size=b, max_epochs=1, hard_negative_refresh=4,
                          steps_per_checkpoint=10_000)
    return task.model_config(8000, t), task.train_config(), pairs, tspace


def drift(recs, ref) -> str:
    """The largest relative loss and grad_norm differences of a
    free-running run's steps from a reference run's, by step."""
    return ", ".join(f"{abs(g[0] - r[0]) / abs(r[0]):.1e}/{abs(g[1] - r[1]) / abs(r[1]):.1e}"
                     for g, r in zip(recs, ref))


def dp_grids(card: str) -> dict:
    """The ranking preset's GRID_STEPS steps through train() on the (2, 1)
    and (4, 1) grids against one card on the same batches. Every grid step
    is held to the one-card step from its own input state (shadow_step:
    loss, grad_norm, params, moments, EMA) and launches the GRU kernels
    data times the one-card step's count. The free-running runs drift
    apart as the one-card run drifts from itself when its initial params
    move by 1e-7 relative: both drifts are logged. Returns the launch
    counts of the (2, 1) run (reset just before it), less those of the
    one-card steps it was held against."""
    import dataclasses as dc

    from sse_tpu_torch import ops
    from sse_tpu_torch.parallel import make_mesh
    from sse_tpu_torch.parallel.mesh import gather
    from sse_tpu_torch.train import grid, init_train_state, loop, train

    mc, tc, pairs, tspace = flagship_problem()
    runs, counts = {}, {}
    for shape in (None, "perturbed", (2, 1), (4, 1)):
        records = []
        undo = recording_steps(records, shadow=isinstance(shape, tuple))
        mesh = make_mesh(*shape, devices=mesh_cards(shape[0])) if isinstance(shape, tuple) \
            else None
        state = init_train_state(mc, tc, device="cuda")
        if shape == "perturbed":
            state = dc.replace(state, params=loop.tree_map(lambda t: t * (1 + 1e-7), state.params))
        ops.reset_launch_counts()
        try:
            state = train(mc, tc, pairs, tspace, mesh=mesh, state=state)
        finally:
            undo()
        torch.cuda.synchronize()
        counts[shape] = ops.launch_counts()
        for r in records:  # the shadow steps are not the grid's path
            for n, c in (r[5] or {}).items():
                counts[shape][n] -= c
        runs[shape] = (state, records)
    one, ref = runs[None]
    check(len(ref) == GRID_STEPS, f"one card: {len(ref)} steps")
    ms = {"one card": sum(r[2] for r in ref[1:]) / (len(ref) - 1)}
    log(f"train one card, params moved by 1e-7 relative, free-running drift of loss/grad_norm "
        f"by step: {drift(runs['perturbed'][1], ref)}")
    for shape in ((2, 1), (4, 1)):
        state, recs = runs[shape]
        check(state.step == GRID_STEPS and len(recs) == GRID_STEPS, f"{shape}: {state.step} steps")
        for i, (g, r) in enumerate(zip(recs, ref)):
            for name in ("gru_fwd", "gru_bwd"):
                check(g[3][name] == shape[0] * r[3][name] > 0,
                      f"{shape} step {i + 1}: {name} launched {g[3][name]} times, one card "
                      f"{r[3][name]}")
        check(grid.copies_identical(state), f"{shape}: the replicas' copies differ")
        worst = max(g[4][0] for g in recs)
        skipped = sum(g[4][1] for g in recs)
        share = max(g[4][2] for g in recs)
        moments = max(g[4][3] for g in recs)
        end = max(float((a - b).abs().max()) for a, b in zip(
            loop.tree_leaves(gather(state.params)), loop.tree_leaves(one.params)))
        ms[str(shape)] = sum(r[2] for r in recs[1:]) / (len(recs) - 1)
        log(f"train grid {shape} (ranking preset, GRU E=H=D=128, B=256, 128 sampled + 16 mined "
            f"negatives, multi-label rows, cache refreshed at step 4): {GRID_STEPS} steps through "
            f"train(); each step from its own input state within rtol 2e-4 (loss, grad_norm), "
            f"Adam's moments within 3e-3 in the 2-norm (at most {moments:.3g}), params and EMA "
            f"within rtol 3e-3 / atol 3e-5 where Adam's update is conditioned (max |d| "
            f"{worst:.3g}; {skipped} elements left out over the steps, at most {share:.3g} of a "
            f"leaf in a step) of the one-card step, every copy identical, gru_fwd/gru_bwd "
            f"{recs[0][3]['gru_fwd']}/"
            f"{recs[0][3]['gru_bwd']} a step (one card {ref[0][3]['gru_fwd']}/"
            f"{ref[0][3]['gru_bwd']}); free-running drift from the one-card run, loss/grad_norm "
            f"by step: {drift(recs, ref)}, final params max |d| {end:.3g}")
    log(f"train grid ms a step (host clock around the synchronized step, steps 2-{GRID_STEPS}; "
        f"one card's grid entries queue on it: a check of the path, not a multi-card speed): "
        f"{json.dumps({k: round(v, 3) for k, v in ms.items()})} [{card}]")

    # the (2, 1) step's split, on the run's final state and first batch
    state = runs[(2, 1)][0]
    step = loop.make_train_step(mc, tc, packed_width=pairs.src.shape[1], num_label_cols=2,
                                mesh=state.mesh)
    packed = torch.from_numpy(loop.pack_batch(next(iter(
        loop.BatchIterator(pairs, tc.batch_size).epoch_batches(0)))))
    tt = torch.from_numpy(tspace.tokens).cuda()
    tl = torch.from_numpy(tspace.lengths).cuda()
    with torch.no_grad():
        cache = loop.sse.target_embeddings(loop.inference_params(state), mc, tokens=tt, lengths=tl)
    grid_split("train grid (2, 1) step", lambda: step(state, packed, tt, tl, cache), card)
    one_step = loop.make_train_step(mc, tc, packed_width=pairs.src.shape[1], num_label_cols=2)
    grid_split("train one-card step", lambda: one_step(one, packed.cuda(), tt, tl, cache), card)
    return counts[(2, 1)]


def largest_alloc(run) -> tuple:
    """(the largest single device allocation of ``run()``, in bytes, and its
    peak memory above what was allocated before it): the allocator's own
    record (torch.cuda.memory's history) and max_memory_allocated."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(max_entries=200_000)
    try:
        out = run()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    sizes = [e["size"] for dev in snap["device_traces"] for e in dev if e["action"] == "alloc"]
    return out, max(sizes), torch.cuda.max_memory_allocated() - base


def tp_grids(card: str) -> None:
    """The classification preset (source encoder only, full softmax,
    dropout 0.1, EMA 0.999; GRU E=H=D=128) at B=128 with a
    GRID_TABLE-row target table: one step on (1, 2), (1, 4) and (2, 2)
    against the one-card step. No grid allocates a whole [B, T] logits
    tensor (the allocator's largest block stays under B·T·4 bytes), where
    the one-card step does."""
    from sse_tpu_torch import configs
    from sse_tpu_torch.data.batching import Batch
    from sse_tpu_torch.parallel import make_mesh
    from sse_tpu_torch.train import grid, init_train_state, loop

    b, t, length = 128, GRID_TABLE, 50
    task = configs.preset("classification", batch_size=b)
    mc, tc = task.model_config(8000, t), task.train_config()
    rng = np.random.default_rng(SEED + 1)
    packed = torch.from_numpy(loop.pack_batch(Batch(
        rng.integers(2, 8000, size=(b, length)).astype(np.int32),
        rng.integers(1, length + 1, size=b).astype(np.int32),
        rng.integers(0, t, size=b).astype(np.int32), np.ones(b, np.float32))))
    dummy_t = torch.zeros((t, 1), dtype=torch.int32, device="cuda")
    dummy_l = torch.ones((t,), dtype=torch.int32, device="cuda")
    s0 = init_train_state(mc, tc, device="cuda")
    one_step = loop.make_train_step(mc, tc, packed_width=length)
    (ref, rm), one_big, one_peak = largest_alloc(lambda: one_step(s0, packed.cuda(), dummy_t,
                                                                  dummy_l))
    logits = b * t * 4
    check(one_big >= logits, f"the one-card step's largest allocation {one_big} < B·T·4")
    one_ms = cuda_ms(lambda: one_step(s0, packed.cuda(), dummy_t, dummy_l), reps=3)
    ms = {"one card": one_ms}
    for shape in ((1, 2), (1, 4), (2, 2)):
        mesh = make_mesh(*shape, devices=mesh_cards(shape[0] * shape[1]))
        placed = grid.place_state(s0, mesh)
        step = loop.make_train_step(mc, tc, packed_width=length, mesh=mesh)
        (got, gm), big, peak = largest_alloc(lambda: step(placed, packed, dummy_t, dummy_l))
        for key in ("loss", "grad_norm", "accuracy"):
            g, r = float(gm[key]), float(rm[key])
            check(abs(g - r) <= 2e-4 * abs(r) + (1e-6 if key == "accuracy" else 0.0),
                  f"TP {shape} {key}: {g} against one card's {r}")
        check(grid.copies_identical(got), f"TP {shape}: the copies differ")
        worst, skipped, share, moments = held_state(f"TP {shape}", grid.gather_state(got), ref)
        check(big < logits, f"TP {shape}: an allocation of {big} bytes, a [B, T] logits "
                            f"tensor is {logits}")
        ms[str(shape)] = cuda_ms(lambda: step(placed, packed, dummy_t, dummy_l), reps=3)
        log(f"train grid TP {shape} (classification preset, B=128, {t:,}-row table over "
            f"'model'): one step, loss/grad_norm/accuracy within rtol 2e-4, Adam's moments within "
            f"3e-3 in the 2-norm (at most {moments:.3g}), params and EMA within rtol 3e-3 / atol "
            f"3e-5 where Adam's update is conditioned (max |d| {worst:.3g}; {skipped} elements "
            f"left out, at most {share:.3g} of a leaf), copies identical; largest allocation "
            f"{big / 2**20:.1f} MiB against {one_big / 2**20:.1f} MiB on one card (a [B, T] "
            f"logits tensor: {logits / 2**20:.1f} MiB); peak above the state "
            f"{peak / 2**30:.2f} GiB against {one_peak / 2**30:.2f} GiB")
        if shape == (1, 2):
            grid_split("train grid TP (1, 2) step",
                       lambda: step(placed, packed, dummy_t, dummy_l), card, reps=2)
        del placed, got
    log(f"train grid TP ms a step (CUDA events, 3 steps after a warm one; the grid's entries "
        f"queue on one card): {json.dumps({k: round(v, 3) for k, v in ms.items()})} [{card}]")


def cp_encodes(card: str) -> None:
    """The transformer recipe's tower (4 pre-LN blocks, E=H=D=128, 4 heads,
    RoPE, mean readout) at B=256, L=512 on cp_mesh(2) and cp_mesh(4)
    against the unsharded encode on the card: embeddings within rtol 2e-5
    / atol 2e-6, the gradients of sum(out · v) within 1e-2 of max(1, max
    |ref|) (tests/test_parallel.py:192, 262); ms an encode each."""
    from sse_tpu_torch.models import towers
    from sse_tpu_torch.parallel.context import cp_mesh, make_cp_encoder
    from sse_tpu_torch.train import loop

    tower = dataclasses.replace(transformer_config().src_tower, readout="mean", max_len=512)
    params = towers.init_tower(tower, torch.Generator().manual_seed(SEED), "cuda")
    b, length = CP_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tokens = torch.randint(2, tower.vocab_size, (b, length), generator=gen, device="cuda")
    lengths = torch.randint(1, length + 1, (b,), generator=gen, device="cuda")
    lengths[:4] = torch.tensor([length, 1, 200, 300], device="cuda")  # full, one token, mid-shard
    v = torch.randn((b, tower.encoding_dim), generator=gen, device="cuda")

    def grads(encode):
        leaves = [x.detach().requires_grad_(True) for x in loop.tree_leaves(params)]
        out = encode(loop._unflatten(params, leaves), tokens, lengths)
        return out.detach(), torch.autograd.grad((out * v).sum(), leaves)

    plain = lambda p, t, n: towers.encode_raw(p, tower, t, n)  # noqa: E731
    ref, ref_g = grads(plain)
    with torch.no_grad():
        ms = {"unsharded": cuda_ms(lambda: plain(params, tokens, lengths), reps=3)}
    for n in (2, 4):
        enc = make_cp_encoder(tower, cp_mesh(n, devices=mesh_cards(n)))
        out, g = grads(enc)
        err = float((out - ref).abs().max())
        check(bool(torch.isfinite(out).all()) and out.shape == ref.shape, f"CP {n}: {out.shape}")
        check(bool(((out - ref).abs() <= 2e-6 + 2e-5 * ref.abs()).all()),
              f"CP {n}: embeddings {err:.3g} from the unsharded encode")
        worst = 0.0
        for a, w in zip(g, ref_g):
            tol = 1e-2 * max(1.0, float(w.abs().max()))
            d = float((a - w).abs().max())
            check(d <= tol, f"CP {n}: a {tuple(w.shape)} gradient {d:.3g} > {tol:.3g}")
            worst = max(worst, d / tol)
        with torch.no_grad():
            ms[f"cp_mesh({n})"] = cuda_ms(lambda: enc(params, tokens, lengths), reps=3)
        log(f"CP encode on cp_mesh({n}) (transformer recipe tower, mean readout, B={b}, "
            f"L={length}): embeddings max |d| {err:.3g} (within rtol 2e-5 / atol 2e-6), "
            f"gradients at most {worst:.3f} of their tolerance")
    log(f"CP encode ms (CUDA events, forward only; the shards queue on one card): "
        f"{json.dumps({k: round(v, 3) for k, v in ms.items()})} [{card}]")


def saved_distance(a: str, b: str) -> float:
    """||p_a - p_b|| / ||p_b|| over every param of the latest checkpoints
    of two model dirs."""
    from sse_tpu_torch.train import loop
    from sse_tpu_torch.train.checkpoint import CheckpointManager

    def params(d):
        mgr = CheckpointManager(os.path.join(d, "ckpt"))
        path = os.path.join(d, "ckpt", str(mgr.latest_step()), "state.pt")
        return loop.tree_leaves(torch.load(path, map_location="cpu", weights_only=True)["params"])

    pa, pb = params(a), params(b)
    diff = sum(float(((x - y).double() ** 2).sum()) for x, y in zip(pa, pb))
    return math.sqrt(diff / sum(float((y.double() ** 2).sum()) for y in pb))


def mp_train(card: str) -> None:
    """Two ranks train through ``python -m sse_tpu_torch.cli train
    --num_processes 2`` (gloo on one card; on a machine with two cards also
    over NCCL, a card each): the ranking preset (GRU) and a transformer
    with the mean readout, on the demo ranking corpus, beside a
    single-process run of the GRU model. Both ranks' final params and eval
    equal each other exactly, and every step of the GRU ranks equals the
    one-card step from the same state (the global batch gathered from both
    ranks; shadow_step's tolerances); rank 0 alone wrote metrics.jsonl and the
    checkpoints. Beside the single process, free-running, the final eval
    is held to two of its N queries, and the params' sums and the
    checkpoints' distance are logged: the runs add in other orders, and 24
    steps of this training amplify that (dp_grids' drift).
    Then ``index --cp_shards 2`` on the transformer's model dir writes the
    rows that ``index`` writes."""
    import shutil

    from sse_tpu_torch import cli
    from sse_tpu_torch.index import ShardedIndex

    shutil.rmtree(MP_TRAIN, ignore_errors=True)
    os.makedirs(MP_TRAIN)
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "SSE_PLATFORM"}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    check(cli.main(["demo-data", "--task", "ranking", "--out_dir",
                    os.path.join(MP_TRAIN, "data")]) == 0, "demo-data")
    base = ["train", "--data_dir", "data", "--task_type", "ranking", "--max_epochs", "2"]
    tf = ["--recipe", "transformer", "--readout", "mean", "--max_epochs", "2"]
    backends = [("gloo", {})]
    if torch.cuda.device_count() >= 2:
        backends = [("gloo", {"CUDA_VISIBLE_DEVICES": "0"}), ("nccl", {})]
    t0 = time.perf_counter()
    for backend, extra_env in backends:
        jobs = {}
        for name, args in (("gru", base), ("tf", base + tf)):
            coord = f"127.0.0.1:{free_port()}"
            for r in range(2):
                jobs[f"{name} rank {r}"] = [*args, "--model_dir", f"{name}_{backend}",
                                            "--num_processes", "2", "--coordinator", coord,
                                            "--process_id", str(r)]
        if backend == "gloo":
            jobs["gru single"] = [*base, "--model_dir", "gru_single"]
        # the GRU ranks' steps are held against the one-card step; the transformer's weights
        # keep a bf16 rounding of their gradient a replica (train/grid.py), so its ranks are held
        # against each other only
        procs = {k: subprocess.Popen([sys.executable, "-c", MP_RUNNER, *a], cwd=MP_TRAIN,
                                     env={**env, **extra_env,
                                          "SMOKE_SHADOW": "1" if k.startswith("gru") else "0"},
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for k, a in jobs.items()}
        outs, errs = {}, {}
        try:
            for k, p in procs.items():
                out, err = p.communicate(timeout=400)
                check(p.returncode == 0, f"{k} ({backend}) exit {p.returncode}:\n{out[-2000:]}"
                                         f"\n{err[-3000:]}")
                outs[k], errs[k] = out, err
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.communicate()

        def parsed(out):
            final = json.loads(out.split("[sse] final eval: ")[1].splitlines()[0])
            sums = json.loads([ln for ln in out.splitlines() if ln.startswith("[params] ")][-1][9:])
            return final, sums

        for name in ("gru", "tf"):
            for r in range(2 if name == "gru" else 0):
                n, held, worst, skipped, share, moments = json.loads([
                    ln for ln in outs[f"{name} rank {r}"].splitlines()
                    if ln.startswith("[held] ")][-1][7:])
                check(n == held == 24, f"{name} rank {r} ({backend}): {held} of {n} steps held")
                log(f"cli train --num_processes 2 ({name}, {backend}) rank {r}: every one of its "
                    f"{n} steps within the one-card step's tolerances from the same state (the "
                    f"global batch gathered; params max |d| {worst:.3g}, {skipped} elements "
                    f"left out, at most {share:.3g} of a leaf; moments at most {moments:.3g} in "
                    f"the 2-norm)")
            (f0, s0), (f1, s1) = parsed(outs[f"{name} rank 0"]), parsed(outs[f"{name} rank 1"])
            check(f0 == f1 and s0 == s1, f"{name} ({backend}): the ranks differ: {f0} {s0} / {f1} "
                                         f"{s1}")
            check(f"over {backend}" in errs[f"{name} rank 0"],
                  f"{name}: not over {backend}: {errs[f'{name} rank 0'][-1000:]}")
            lines = open(os.path.join(MP_TRAIN, f"{name}_{backend}", "metrics.jsonl")).read()
            check(lines.count('"final": 1') == 1, f"{name} ({backend}): metrics.jsonl {lines[-500:]}")
            log(f"cli train --num_processes 2 ({name}, {backend}): both ranks final eval {f0}, "
                f"params sum / sum |.| {s0}")
        if backend == "gloo":
            fs, ss = parsed(outs["gru single"])
            (f0, s0) = parsed(outs["gru rank 0"])
            rel = saved_distance(os.path.join(MP_TRAIN, "gru_gloo"),
                                 os.path.join(MP_TRAIN, "gru_single"))
            n_eval = sum(1 for _ in open(os.path.join(MP_TRAIN, "data", "EvalPairs")))
            log(f"cli train, one process (gru): final eval {fs}, params sum / sum |.| {ss}; the "
                f"ranks' run, free-running beside it: final eval {f0}, params {s0}, checkpoint "
                f"distance ||d|| / ||p|| {rel:.3g}")
            # free-running, the two runs add in other orders and drift apart (dp_grids): the
            # eval is held to two of its N queries
            for key, val in fs.items():
                check(abs(f0[key] - val) <= 2.0 / n_eval,
                      f"gru ranks' final {key} {f0[key]} against one process's {val}")
    log(f"cli train --num_processes 2: {time.perf_counter() - t0:.1f} s for "
        f"{len(backends)} backend(s) [{card}]")
    model_dir = os.path.join(MP_TRAIN, "tf_gloo")
    data_dir = os.path.join(MP_TRAIN, "data")
    rows = {}
    for extra in ([], ["--cp_shards", "2"]):
        check(cli.main(["index", "--model_dir", model_dir, "--data_dir", data_dir, *extra]) == 0,
              f"index {extra}")
        rows[bool(extra)] = ShardedIndex.load(os.path.join(model_dir, "index"), "cuda").emb
    err = float((rows[True] - rows[False]).abs().max())
    check(bool(((rows[True] - rows[False]).abs() <= 2e-6 + 2e-5 * rows[False].abs()).all()),
          f"index --cp_shards 2: rows {err:.3g} from index's")
    log(f"index --cp_shards 2 on the two-rank transformer's model dir: the rows of index "
        f"(max |d| {err:.3g})")


def dryrun_multichip(n: int) -> None:
    """The counterpart of ``__graft_entry__.dryrun_multichip``: one full
    sharded step of the source-encoder-only, full-softmax model (2-layer
    residual GRU, E=H=D=16, 8·model targets) on an ``n``-entry grid with
    model=2 (entry i on card i mod the cards), held to the unsharded step:
    a finite loss, the same loss (rtol 2e-4) and the same updated table
    (rtol 3e-3 / atol 3e-5)."""
    from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
    from sse_tpu_torch.models.towers import TowerConfig
    from sse_tpu_torch.parallel import make_mesh
    from sse_tpu_torch.parallel.mesh import RowShards, gather
    from sse_tpu_torch.train import LossConfig, TrainConfig, grid, init_train_state, loop

    model = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = make_mesh(n // model, model, devices=mesh_cards(n))
    mc = SSEConfig(mode=NetworkMode.SOURCE_ENCODER_ONLY,
                   src_tower=TowerConfig(vocab_size=128, embed_dim=16, hidden=16, num_layers=2,
                                         encoding_dim=16, residual=True),
                   num_targets=8 * model)
    tc = TrainConfig(batch_size=2 * n, loss=LossConfig(kind="full"))
    state = grid.place_state(init_train_state(mc, tc, device="cuda"), mesh)
    check(isinstance(state.params["target_table"], RowShards), "table not over 'model'")
    gen = torch.Generator(device="cuda").manual_seed(0)
    b = tc.batch_size
    src = torch.randint(2, 128, (b, 10), generator=gen, device="cuda", dtype=torch.int32)
    src_len = torch.full((b,), 10, dtype=torch.int32, device="cuda")
    labels = torch.randint(0, 8 * model, (b,), generator=gen, device="cuda", dtype=torch.int32)
    weight = torch.ones((b,), device="cuda")
    dummy = (torch.zeros((8 * model, 10), dtype=torch.int32, device="cuda"),
             torch.ones((8 * model,), dtype=torch.int32, device="cuda"))
    new, m = loop.make_train_step(mc, tc, mesh=mesh)(state, src, src_len, labels, weight, *dummy)
    loss = float(m["loss"])
    check(math.isfinite(loss), f"dryrun_multichip({n}): loss {loss}")
    ref, rm = loop.make_train_step(mc, tc)(init_train_state(mc, tc, device="cuda"), src, src_len,
                                           labels, weight, *dummy)
    check(abs(loss - float(rm["loss"])) <= 2e-4 * abs(float(rm["loss"])),
          f"dryrun_multichip({n}): loss {loss} against {float(rm['loss'])}")
    got, want = gather(new.params)["target_table"], ref.params["target_table"]
    check(bool(((got - want).abs() <= 3e-5 + 3e-3 * want.abs()).all()),
          f"dryrun_multichip({n}): the updated table differs")
    log(f"dryrun_multichip({n}): one sharded step on a {mesh.shape} grid, loss {loss:.6f} "
        f"(unsharded {float(rm['loss']):.6f}), the table within rtol 3e-3 / atol 3e-5")


GRID_CHAIN_RUNS = (("ranking", (2, 1)), ("ranking", (4, 1)), ("classification", (1, 2)),
                   ("classification", (1, 4)), ("classification", (2, 2)))


def sync_cards() -> None:
    """Every card of this process synchronized; in a rank of a process
    group, its own card, then every rank at a barrier."""
    from sse_tpu_torch.parallel import distributed

    if distributed.world_size() > 1:
        torch.cuda.synchronize(distributed.local_device())
        distributed.barrier()
        return
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def grid_chain_problem(task: str, shape):
    """(model config, train config, mesh, state on it, chunks, target
    tokens, lengths, mining cache (``Replicated``), label columns, B) of a
    chained grid run: the ranking preset as dp_grids trains it
    (flagship_problem: B=256, 128 sampled and 16 mined negatives, 4,096
    targets, multi-label rows), the classification preset as tp_grids
    steps it (B=128, GRID_TABLE rows, dropout 0.1, EMA); 6 chunks of CHAIN
    packed batches each, on the lead card. In a rank of a process group
    the grid spans the ranks, each holding whole grid rows on its card,
    and its chunks hold its rows of each global batch."""
    from sse_tpu_torch import configs
    from sse_tpu_torch.data.batching import Batch
    from sse_tpu_torch.parallel import distributed, make_mesh
    from sse_tpu_torch.parallel.mesh import Replicated
    from sse_tpu_torch.train import grid, init_train_state, loop

    ranks, rank = distributed.world_size(), distributed.rank()
    entries = shape[0] * shape[1]
    mesh = make_mesh(*shape, devices=mesh_cards(entries) if ranks == 1 else
                     [distributed.local_device()] * (entries // ranks))
    lead = mesh.local_devices[0]
    copies = lambda x: Replicated({c: x.to(c) for c in mesh.local_devices})  # noqa: E731
    n = 6 * CHAIN
    if task == "ranking":
        mc, tc, pairs, tspace = flagship_problem(steps=n)
        tc = dataclasses.replace(tc, steps_per_dispatch=CHAIN)
        it = loop.BatchIterator(pairs, tc.batch_size, seed=tc.seed)
        packed = [loop.pack_batch(x) for x in it.epoch_batches(0)][:n]
        tt, tl = (torch.from_numpy(x).to(lead) for x in (tspace.tokens, tspace.lengths))
        cols = 2
    else:
        b, t, length = 128, GRID_TABLE, 50
        task_cfg = configs.preset("classification", batch_size=b, steps_per_dispatch=CHAIN)
        mc, tc = task_cfg.model_config(8000, t), task_cfg.train_config()
        rng = np.random.default_rng(SEED + 2)
        packed = [loop.pack_batch(Batch(
            rng.integers(2, 8000, size=(b, length)).astype(np.int32),
            rng.integers(1, length + 1, size=b).astype(np.int32),
            rng.integers(0, t, size=b).astype(np.int32), np.ones(b, np.float32)))
            for _ in range(n)]
        tt = torch.zeros((t, 1), dtype=torch.int32, device=lead)
        tl = torch.ones((t,), dtype=torch.int32, device=lead)
        cols = 1
    bl = tc.batch_size // ranks  # this rank's rows of each global batch
    chunks = [torch.from_numpy(np.stack(packed[i : i + CHAIN])[:, rank * bl : (rank + 1) * bl]
                               ).to(lead) for i in range(0, n, CHAIN)]
    state = grid.place_state(init_train_state(mc, tc, device=lead), mesh)
    cache = None
    if task == "ranking":
        with torch.no_grad():
            cache = copies(loop.sse.target_embeddings(loop.inference_params(state), mc,
                                                      tokens=tt, lengths=tl))
    return mc, tc, mesh, state, chunks, copies(tt), copies(tl), cache, cols, tc.batch_size


def grid_state_copy(state):
    from sse_tpu_torch.train import grid

    return grid.with_tensors(state, [x.clone() for x in grid.state_tensors(state)], state.step)


def grid_chain_run(card: str, task: str, shape) -> dict:
    """One chained grid run (``make_train_step(mesh=, chain=CHAIN)``,
    ``loop._GridChain``): a replay from the run's state against CHAIN
    eager grid steps from it, and a second replay carrying the state the
    first returned (its buffers, the next steps' seeds) against CHAIN
    more (bit for bit where two eager runs are, else as held_state holds
    a state); the eager steps of that chain (every one
    for the ranking preset, the first for the classification preset)
    held against the one-card step from their own input states
    (shadow_step, as dp_grids and tp_grids hold a grid step), so the
    replay is held against the one-card step through them; four replays under
    ``torch.cuda.set_sync_debug_mode("error")`` and every copy identical
    after them; the recurrent launches a replayed step, data x the
    one-card step's; the captures (graphs a card, copies), the seconds and
    MiB a card of the capture; ms a step chained against eager over the
    same 6 x CHAIN batches, each run carrying its state (host clock to
    every card synchronized); each card's busy share of a window of 8
    replays (card_busy). Returns the launch counts of the timed replays.

    In a rank of a process group over NCCL (process_rank) the grid spans
    the ranks, a card each, and the chain is one graph a rank with its
    collectives inside: the same checks on every rank, and besides, every
    rank's state bits after the replays equal (a digest compared over
    gloo), the collectives of a replayed step, the slowest rank's ms a
    step, and the device ms of ``sse.train.grad_sum`` (the gradients'
    all_reduces) a step, from three eager steps under torch.profiler."""
    from sse_tpu_torch import ops
    from sse_tpu_torch.parallel import distributed
    from sse_tpu_torch.train import grid, loop

    mc, tc, mesh, state, chunks, tt, tl, cache, cols, b = grid_chain_problem(task, shape)
    ranks = distributed.world_size()
    width = 50
    single = loop.make_train_step(mc, tc, packed_width=width, num_label_cols=cols, mesh=mesh)
    eager = loop._eager_chain(single, CHAIN)
    chain = loop.make_train_step(mc, tc, packed_width=width, num_label_cols=cols, mesh=mesh,
                                 chain=CHAIN)
    label = f"{task} {shape}" + (f" rank {distributed.rank()} of {ranks}" if ranks > 1 else "")
    check(ranks == 1 or (distributed.captures() and hasattr(chain, "chains")),
          f"{label}: the chain across processes is not captured (backend {distributed.backend()})")
    e1, em = eager(state, chunks[1], tt, tl, cache)
    e1, em = grid_state_copy(e1), {k: v.clone() for k, v in em.items()}
    e2, _ = eager(state, chunks[1], tt, tl, cache)
    sync_cards()
    reserved = {c: torch.cuda.memory_reserved(c) for c in mesh.local_devices}
    t0 = time.perf_counter()
    chain(state, chunks[0], tt, tl, cache)  # warm-up step, capture, first replay
    sync_cards()
    capture_s = time.perf_counter() - t0
    pool_mib = {str(c): round((torch.cuda.memory_reserved(c) - r) / 2**20, 1)
                for c, r in reserved.items()}
    made = next(iter(chain.chains.values()))
    graphs_a_card = {str(c): n for c, n in made.rec.graphs.items()}
    n_copies = sum(a[0] == "copy" for a in made.rec.actions)
    if len(mesh.local_devices) == 1:
        check(made.rec.graphs == {mesh.local_devices[0]: 1} and n_copies == 0,
              f"{label}: one card took {made.rec.graphs} graphs and {n_copies} copies, want 1, 0")
    gr, gm = chain(state, chunks[1], tt, tl, cache)
    g, gm = grid_state_copy(gr), {k: v.clone() for k, v in gm.items()}
    # a second replay carries the state the first returned (its buffers, new seeds)
    g2, gm2 = chain(gr, chunks[2], tt, tl, cache)
    g2, gm2 = grid_state_copy(g2), {k: v.clone() for k, v in gm2.items()}
    e3, em3 = eager(e1, chunks[2], tt, tl, cache)
    leaves = grid.state_tensors
    if all(torch.equal(x, y) for x, y in zip(leaves(e1), leaves(e2))):
        for got, gms, ref, ems, which in ((g, gm, e1, em, "a replay"),
                                          (g2, gm2, e3, em3, "a replay carrying the state")):
            check(all(torch.equal(x, y) for x, y in zip(leaves(got), leaves(ref))) and all(
                torch.equal(gms[k], ems[k]) for k in ems),
                f"{label}: {which} differs from the eager grid steps, which are bit for bit run "
                f"to run")
        held = "bit for bit, and a second replay carrying its state too (two eager runs are bit " \
               "for bit)"
    else:
        drift_ = held_state(f"{label} eager against eager", grid.gather_state(e2),
                            grid.gather_state(e1))
        got = held_state(f"{label} replay against eager", grid.gather_state(g),
                         grid.gather_state(e1))
        held_state(f"{label} replay carrying the state against eager", grid.gather_state(g2),
                   grid.gather_state(e3))
        for k in ("loss", "grad_norm"):
            for gms, ems in ((gm, em), (gm2, em3)):
                rel = float(((gms[k] - ems[k]).abs() / ems[k].abs()).max())
                check(rel <= 2e-4, f"{label}: replay's {k} {rel:.3g} from the eager steps' "
                                   f"(rtol 2e-4)")
        held = (f"held as held_state holds a state, a second replay carrying its state too: "
                f"params max |d| {got[0]:.3g}, {got[1]} elements left out, moments {got[3]:.3g} "
                f"(eager against eager: {drift_[0]:.3g}, {drift_[1]}, {drift_[3]:.3g})")
    del gr, g2, e3
    # the eager steps of that chain against the one-card step from their own input states: every
    # one of the ranking preset's (as dp_grids), the classification preset's first (as tp_grids;
    # on (2, 2) a second step left one element of a (256, 384) GRU weight 2.8e-4 out where Adam's
    # update is conditioned: the weights' gradients keep a rounding a replica, train/grid.py)
    plain = loop.make_train_step(mc, tc, packed_width=width, num_label_cols=cols)
    s, shadow = state, []
    for i in range(CHAIN if task == "ranking" else 1):
        new, m = single(s, chunks[1][i], tt, tl, cache)
        shadow.append(shadow_step(plain, s, new, m, (chunks[1][i], tt, tl),
                                  {"tgt_emb_cache": cache}, i + 1))
        s = new
    del s, new
    worst = max(h[0] for h in shadow)
    # four replays under sync debug: from the state the last replay returned, a rebound lr,
    # another state
    host = chunks[2].cpu().pin_memory()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, m = chain(state, host, tt, tl, cache)
        st, m = chain(st, host, tt, tl, cache)
        st, m = chain(dataclasses.replace(st, lr=st.lr * 0.5), host, tt, tl, cache)
        st, m = chain(state, host, tt, tl, cache)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sync_cards()
    check(bool(torch.isfinite(m["loss"]).all()), f"{label}: non-finite loss {m['loss']}")
    check(grid.copies_identical(st), f"{label}: the copies differ after the replays")
    if ranks > 1:
        digests = distributed.all_gather_object(state_digest(grid.state_tensors(st)))
        check(len(set(digests)) == 1, f"{label}: the ranks' states differ after the replays")
    # the recurrent launches of a replayed step against the one-card step's
    one = loop.init_train_state(mc, tc, device=mesh.local_devices[0])
    on = lambda x: None if x is None else next(iter(x.values()))  # noqa: E731
    ops.reset_launch_counts()
    plain(one, chunks[0][0], on(tt), on(tl), on(cache))
    sync_cards()
    per_step = {n: c for n, c in ops.launch_counts().items() if n in RNN_KERNELS and c}
    del one
    # ms a step over the same 48 batches, chained and eager, each carrying its state
    times = {}
    for how, fn in (("chained", chain), ("eager", eager)):
        st = state
        ops.reset_launch_counts()
        sync_cards()
        t0 = time.perf_counter()
        for c in chunks:
            st, m = fn(st, c, tt, tl, cache)
        sync_cards()
        times[how] = (time.perf_counter() - t0) * 1e3 / (len(chunks) * CHAIN)
        if how == "chained":
            counts = ops.launch_counts()
    data = shape[0] // ranks  # this process's replicas
    check(all(counts[n] == data * c * len(chunks) * CHAIN for n, c in per_step.items())
          and per_step, f"{label}: {len(chunks)} replays launched {counts}, want data x "
                        f"{per_step} a step")
    collectives = {n: c // CHAIN for n, c in made.launches.collectives.items()}
    slowest, grad_sum = "", ""
    if ranks > 1:
        every = distributed.all_gather_object(times)
        slowest = (f"; the slowest rank's ms a step chained {max(t['chained'] for t in every):.4f}"
                   f" against eager {max(t['eager'] for t in every):.4f}")
        split = grid_split(f"train grid {label} eager step",
                           lambda: single(state, chunks[0][0], tt, tl, cache), card)
        grad_sum = (f"; sse.train.grad_sum {split.get('sse.train.grad_sum', NOT_MEASURED):.4f} ms "
                    f"a step (torch.profiler, eager steps)")
    wall, busy = card_busy([lambda c=c: chain(state, c, tt, tl, cache) for c in chunks[:2]],
                           window=8)
    shares = ", ".join(f"cuda:{i} {100.0 * t / wall:.1f}%" for i, t in sorted(busy.items()))
    log(f"train grid chain {label} (B={b}, {CHAIN} steps a chunk): capture {capture_s:.3f} s "
        f"(warm-up step, recording, first replay; {made.rec.seconds:.3f} s the warm-up and "
        f"recording), graphs a card {graphs_a_card}, {n_copies} copies between cards, memory "
        f"reserved by it a card (MiB) {pool_mib}, of which the recording's pools "
        f"{ {str(c): round(v, 1) for c, v in made.rec.mib.items()} }; replay against {CHAIN} eager grid steps from "
        f"one state: {held}; {len(shadow)} eager steps against the one-card step from their "
        f"input states (shadow_step): params max |d| {worst:.3g}, {sum(h[1] for h in shadow)} elements left "
        f"out; 4 replays under set_sync_debug_mode('error'), copies identical; launches a "
        f"replayed step { {n: counts[n] // (len(chunks) * CHAIN) for n in per_step} } (one card "
        f"{per_step}), collectives a replayed step {collectives}; ms a step over "
        f"{len(chunks) * CHAIN} batches chained {times['chained']:.4f} against eager "
        f"{times['eager']:.4f}, {times['eager'] / times['chained']:.2f}x{slowest}; busy over 8 "
        f"replays ({wall:.2f} ms): {shares}{grad_sum} [{card}]")
    return counts


def grid_chain_train(card: str) -> None:
    """The ranking preset through train() on a (2, 1) grid at
    steps_per_dispatch CHAIN against 1 (ranking_chain_corpus, one epoch of
    64 steps at B=128, a log record every 16 steps): the same log steps,
    finite losses, and the same losses where the eager grid step is bit
    for bit run to run (else within rtol 2e-4 of each other at the first
    log step, the drift after it logged)."""
    from sse_tpu_torch.parallel import make_mesh
    from sse_tpu_torch.train import init_train_state, train

    mc, task, pairs, _, tspace = ranking_chain_corpus()
    logs, secs = {}, {}
    for k in (CHAIN, 1):
        tc = dataclasses.replace(task.train_config(), steps_per_dispatch=k, max_epochs=1,
                                 steps_per_checkpoint=16)
        mesh = make_mesh(2, 1, devices=mesh_cards(2))
        records = []
        state = init_train_state(mc, tc, device=mesh.local_devices[0])
        sync_cards()
        t0 = time.perf_counter()
        state = train(mc, tc, pairs, tspace, log_fn=records.append, state=state, mesh=mesh)
        sync_cards()
        secs[k] = time.perf_counter() - t0
        check(state.step == 64 and all(math.isfinite(r["loss"]) for r in records),
              f"train grid K={k}: {state.step} steps, {records}")
        logs[k] = records
    r8, r1 = logs[CHAIN], logs[1]
    check([r["step"] for r in r8] == [r["step"] for r in r1], f"train grid: log steps {r8} / {r1}")
    same = [r["loss"] for r in r8] == [r["loss"] for r in r1]
    check(same or abs(r8[0]["loss"] - r1[0]["loss"]) <= 2e-4 * abs(r1[0]["loss"]),
          f"train grid: losses {[r['loss'] for r in r8]} against {[r['loss'] for r in r1]}")
    log(f"train(mesh=(2, 1)) ranking preset, 64 steps (B=128, a log record every 16): "
        f"steps_per_dispatch={CHAIN} {secs[CHAIN]:.2f} s against 1: {secs[1]:.2f} s; log steps "
        f"{[r['step'] for r in r8]} equal; window losses {'equal' if same else 'differ'}: "
        f"{[round(r['loss'], 6) for r in r8]} against {[round(r['loss'], 6) for r in r1]} [{card}]")


def grid_chains(card: str) -> dict:
    """The grid's chained train steps (phase 8's captured chain): each of
    GRID_CHAIN_RUNS through grid_chain_run, then grid_chain_train. Returns
    the replays' launch counts, summed."""
    t0 = time.perf_counter()
    counts = collections.Counter()
    for task, shape in GRID_CHAIN_RUNS:
        counts.update(grid_chain_run(card, task, shape))
        torch.cuda.empty_cache()
    grid_chain_train(card)
    log(f"train grid chains: {time.perf_counter() - t0:.1f} s")
    return dict(counts)


def train_grid_slice(card: str) -> dict:
    """Training on a grid (``train.grid``, ``parallel.context``): DP with the
    flagship loss (dp_grids), TP with the 'model'-sharded table
    (tp_grids), the chained grid steps (grid_chains), the
    context-parallel encode (cp_encodes), two ranks through the CLI and
    index --cp_shards (mp_train), dryrun_multichip(4). Every grid entry
    is cuda:0 on one card (entry i on cuda:(i mod n) where there are n).
    Returns the launch counts of the (2, 1) DP run and of the chained
    runs' timed replays."""
    t0 = time.perf_counter()
    count = torch.cuda.device_count()
    log("train grid: " + ("every grid entry is cuda:0: the entries share one card and their "
                          "launches run one after another" if count == 1 else
                          f"{count} cards: grid entry i is cuda:(i mod {count})"))
    counts = collections.Counter(dp_grids(card))
    tp_grids(card)
    counts.update(grid_chains(card))
    cp_encodes(card)
    dryrun_multichip(4)
    mp_train(card)
    log(f"train grid phase: {time.perf_counter() - t0:.1f} s")
    return dict(counts)


# ------------------------------------ grids across processes (phase 12)
PROCESS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "process_chains")
PROCESS_LIMIT = 600  # seconds a group of rank processes may take
PROCESS_KERNELS = ("gru_fwd", "gru_bwd", "topk_stream", "twophase_p1", "twophase_p2")


def state_digest(tensors) -> str:
    """sha256 over the tensors' bytes: equal digests are equal bits."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def process_runs(n: int) -> tuple:
    """The chained grid runs of a group of n ranks: the ranking preset on
    (n, 1); at n = 2 also the classification preset on (2, 1) and on (2,
    2), where each rank's card holds both blocks of its grid row."""
    more = (("classification", (2, 1)), ("classification", (2, 2))) if n == 2 else ()
    return (("ranking", (n, 1)),) + more


def run_ranks(jobs: dict, limit: float, where: str, cwd=None, envs=None) -> dict:
    """Start every job (name → argv; its environment ``envs[name]``, else
    this process's) at once, its output in files under ``where``, and
    wait for all within ``limit`` s; a job that fails ends the others (a
    rank left in a collective would wait for NCCL's timeout). Returns
    name → (exit code, stdout, stderr)."""
    os.makedirs(where, exist_ok=True)
    files, procs = {}, {}
    for name, argv in jobs.items():
        stem = os.path.join(where, name.replace(" ", "_"))
        files[name] = (open(stem + ".out", "w+"), open(stem + ".err", "w+"))
        procs[name] = subprocess.Popen(argv, stdout=files[name][0], stderr=files[name][1],
                                       text=True, cwd=cwd, env=(envs or {}).get(name))
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs.values()):
            if time.perf_counter() - t0 > limit or any(p.poll() for p in procs.values()):
                break
            time.sleep(0.5)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
    out = {}
    for name, (o, e) in files.items():
        o.seek(0)
        e.seek(0)
        out[name] = (procs[name].returncode, o.read(), e.read())
        o.close()
        e.close()
    return out


def process_rank(rank: int, n: int, coord: str) -> None:
    """One rank of process_group: joins the group (card ``rank``, NCCL),
    runs process_runs(n) through grid_chain_run and process_serving, and
    prints its launch counts on a RESULT line."""
    from sse_tpu_torch.parallel import distributed

    distributed.initialize(coord, n, rank)
    card = card_line()
    check(distributed.captures(), f"rank {rank}: device collectives over "
                                  f"{distributed.backend()}, not NCCL on a card a rank")
    handling = os.environ.get("TORCH_NCCL_ASYNC_ERROR_HANDLING", "unset: PyTorch's default")
    log(f"rank {rank} of {n} on {distributed.local_device()}: NCCL {distributed.nccl_version()}, "
        f"TORCH_NCCL_ASYNC_ERROR_HANDLING {handling}, torch {torch.__version__}")
    counts = collections.Counter()
    for task, shape in process_runs(n):
        counts.update(grid_chain_run(card, task, shape))
        torch.cuda.empty_cache()
    counts.update(process_serving(card, n))
    print("RESULT " + json.dumps(dict(counts)), flush=True)
    torch.distributed.destroy_process_group()


def process_serving(card: str, n: int) -> dict:
    """In a rank: a (1, n) grid across the n ranks serving the bench's GRU
    model over SHARDED_ROWS random unit rows, bf16 and int8, B=8 and 4096,
    k=10. The capturing call, a replay under sync debug "error" and the
    eager call (``.run``) bit for bit; the exchange and the merge inside
    the rank's graph (``GridQuery.exchange``), one capture a shape; the
    replay's rows and values saved for process_group to hold against the
    single process's unsharded call; ms a call replayed and eager (CUDA
    events, every rank's). Returns the replays' launch counts."""
    from sse_tpu_torch import bench, ops
    from sse_tpu_torch.models import sse
    from sse_tpu_torch.parallel import RowShards, distributed, make_mesh
    from sse_tpu_torch.serve.engine import build_fused_query_fn

    rank, dev = distributed.rank(), distributed.local_device()
    mesh = make_mesh(1, n, devices=[dev])
    cfg = bench._default_model()
    params = sse.init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    counts = collections.Counter()
    for dtype in (torch.bfloat16, torch.int8):
        name = str(dtype)[6:]
        emb = RowShards.from_tensor(bench._device_index(SHARDED_ROWS, D, dtype, dev, shards=n),
                                    mesh)
        torch.cuda.empty_cache()
        fn = build_fused_query_fn(cfg, K, SHARDED_ROWS, mesh=mesh)
        check(fn.exchange, f"rank {rank}: the grid query's exchange is not captured")
        for i, b in enumerate((8, 4096)):
            label = f"served (1, {n}) rank {rank} {name} B={b}"
            toks, lens = sharded_tokens(b, 7 + b, dev)
            first = fn(params, emb, toks, lens)  # the capture, its warm-up this call's result
            sync_cards()
            before = ops.launch_counts()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = fn(params, emb, toks, lens)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            sync_cards()
            after = ops.launch_counts()
            launched = {k: after[k] - before[k] for k in after if after[k] > before[k]}
            counts.update(launched)
            eager = uncounted(lambda: fn.run(params, emb, toks, lens, SHARDED_ROWS))
            same(f"{label}: replay against eager", got, eager)
            same(f"{label}: the capture's warm-up against eager", first, eager)
            check(fn.stats.counts() == {"graph_captures": i + 1, "graph_replays": 1 + 7 * i,
                                        "graph_eager": 0},
                  f"{label}: {fn.stats.counts()}")
            torch.save((got[0].cpu().clone(), got[1].cpu().clone()),
                       os.path.join(PROCESS_DIR, f"n{n}_rank{rank}_{name}_b{b}.pt"))
            replayed = cuda_ms(lambda: fn(params, emb, toks, lens), 5)
            eager_ms = uncounted(lambda: cuda_ms(
                lambda: fn.run(params, emb, toks, lens, SHARDED_ROWS), 5))
            every = distributed.all_gather_object((replayed, eager_ms))
            if rank == 0:
                log(f"served (1, {n}) across {n} processes over NCCL, {name} B={b} k={K}: one "
                    f"capture a rank (the exchange and the merge inside its graph), a replay == "
                    f"eager == the capture's warm-up bit for bit under sync debug 'error'; "
                    f"launches a replay {launched}; ms a call (CUDA events) replayed / eager by "
                    f"rank: {', '.join(f'{r:.4f} / {e:.4f}' for r, e in every)} [{card}]")
        del emb, fn
        torch.cuda.empty_cache()
    return dict(counts)


def process_group(card: str, n: int) -> dict:
    """n rank processes (``chip_smoke.py --process-rank R n COORD``), rank r
    on card r over NCCL, each running process_runs(n) (grid_chain_run) and
    process_serving; their logs relayed. Then every rank's served rows and
    values against the single process's unsharded call on the same index
    and tokens, bit for bit. Returns the ranks' launch counts, summed."""
    from sse_tpu_torch import bench
    from sse_tpu_torch.models import sse
    from sse_tpu_torch.serve.engine import build_fused_query_fn

    coord = f"127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    jobs = {f"rank {r} of {n}": [sys.executable, os.path.abspath(__file__), "--process-rank",
                                 str(r), str(n), coord] for r in range(n)}
    outs = run_ranks(jobs, PROCESS_LIMIT, os.path.join(PROCESS_DIR, f"logs{n}"))
    counts = collections.Counter()
    for name, (rc, out, err) in outs.items():
        for line in out.splitlines():
            if line.startswith("RESULT "):
                counts.update(json.loads(line[len("RESULT "):]))
            else:
                log(f"  {name}: {line}")
        for line in err.splitlines():
            if line.startswith("[sse]"):
                log(f"  {name}: {line}")
        check(rc == 0, f"{name} failed ({rc}):\n{out[-3000:]}\n{err[-5000:]}")
    log(f"process group of {n}: every rank done in {time.perf_counter() - t0:.1f} s")
    cfg = bench._default_model()
    params = sse.init_params(cfg, torch.Generator().manual_seed(SEED), "cuda")
    for dtype in (torch.bfloat16, torch.int8):
        full = sharded_rows(dtype)[:SHARDED_ROWS]
        fn = build_fused_query_fn(cfg, K, SHARDED_ROWS)
        for b in (8, 4096):
            toks, lens = sharded_tokens(b, 7 + b)
            want = fn(params, full, toks, lens)
            for r in range(n):
                got = torch.load(os.path.join(PROCESS_DIR, f"n{n}_rank{r}_{str(dtype)[6:]}_b{b}.pt"))
                same(f"(1, {n}) rank {r} {dtype} B={b} against one process",
                     (got[0].cuda(), got[1].cuda()), want)
        del full
        torch.cuda.empty_cache()
    log(f"served (1, {n}) across {n} processes: every rank's rows and values at B=8 and 4096, "
        f"bf16 and int8, == the single process's unsharded call bit for bit")
    return dict(counts)


def mp_chain_train(card: str, n: int) -> None:
    """``cli train --num_processes n`` over NCCL (a card a rank) on the
    demo ranking corpus (24 steps, a log record every 8) at
    steps_per_dispatch 8, its captured chains replaying 2 chunks, against
    1, twice: both log the same steps, and the same losses bit for bit
    where the two K=1 runs agree (else within rtol 2e-4 at the first log
    record); every rank's final params equal. The K=8 ranks run under
    recording_steps(shadow=True): every step also runs eagerly and is held
    against the one-card step from the same state, and each chunk's
    replay against those steps (CHAIN_CHECKS)."""
    from sse_tpu_torch import cli

    where = os.path.join(PROCESS_DIR, f"cli{n}")
    os.makedirs(where, exist_ok=True)
    check(cli.main(["demo-data", "--task", "ranking", "--out_dir",
                    os.path.join(where, "data")]) == 0, "demo-data")
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "SSE_PLATFORM"}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    base = ["train", "--data_dir", "data", "--task_type", "ranking", "--max_epochs", "2",
            "--steps_per_checkpoint", "8"]
    jobs, envs = {}, {}
    for run, k in (("k8", 8), ("k1", 1), ("k1b", 1)):
        coord = f"127.0.0.1:{free_port()}"
        for r in range(n):
            jobs[f"{run} rank {r}"] = [sys.executable, "-c", MP_RUNNER, *base, "--model_dir", run,
                                       "--steps_per_dispatch", str(k), "--num_processes", str(n),
                                       "--coordinator", coord, "--process_id", str(r)]
            envs[f"{run} rank {r}"] = {**env, "SMOKE_SHADOW": "1" if run == "k8" else "0"}
    t0 = time.perf_counter()
    outs = run_ranks(jobs, PROCESS_LIMIT, os.path.join(where, "logs"), cwd=where, envs=envs)
    for name, (rc, out, err) in outs.items():
        check(rc == 0, f"{name} exit {rc}:\n{out[-2000:]}\n{err[-4000:]}")
        check("over nccl" in err, f"{name}: not over NCCL: {err[-1000:]}")

    def line(name, tag):
        return json.loads([x for x in outs[name][1].splitlines() if x.startswith(tag)][-1][len(tag):])

    params = {name: line(name, "[params] ") for name in jobs}
    for run in ("k8", "k1", "k1b"):
        check(all(params[f"{run} rank {r}"] == params[f"{run} rank 0"] for r in range(n)),
              f"{run}: the ranks' final params differ: {[params[f'{run} rank {r}'] for r in range(n)]}")
    chains = line("k8 rank 0", "[chains] ")
    n_steps, held = line("k8 rank 0", "[held] ")[:2]
    check(len(chains) == 2 and n_steps == held == 24,
          f"K=8: {len(chains)} chains held, {held} of {n_steps} steps held")
    logs = {}
    for run in ("k8", "k1", "k1b"):
        with open(os.path.join(where, run, "metrics.jsonl")) as f:
            logs[run] = [json.loads(x) for x in f if '"loss"' in x and '"final"' not in x]
    steps = {run: [r["step"] for r in recs] for run, recs in logs.items()}
    losses = {run: [r["loss"] for r in recs] for run, recs in logs.items()}
    check(steps["k8"] == steps["k1"] == steps["k1b"] == [8, 16, 24], f"log steps {steps}")
    repeat = losses["k1"] == losses["k1b"]
    if repeat:
        check(losses["k8"] == losses["k1"], f"K=8 losses {losses['k8']} against K=1's "
                                            f"{losses['k1']}, which repeat bit for bit")
    else:
        check(abs(losses["k8"][0] - losses["k1"][0]) <= 2e-4 * abs(losses["k1"][0]),
              f"K=8 losses {losses['k8']} against K=1's {losses['k1']}")
    log(f"cli train --num_processes {n} over NCCL (ranking preset, 24 steps, a log record every "
        f"8): steps_per_dispatch 8, its 2 chunks replayed from captured chains, each replay "
        f"against its eager steps {chains}, every step within the one-card step's tolerances "
        f"from the same state; against 1 (twice): log steps {steps['k8']} equal, losses "
        f"{'bit for bit' if losses['k8'] == losses['k1'] else 'apart'} ({losses['k8']} / "
        f"{losses['k1']}; two K=1 runs {'agree' if repeat else 'differ'}); every rank's final "
        f"params equal (sum / sum |.| {params['k8 rank 0']}); {time.perf_counter() - t0:.1f} s "
        f"[{card}]")


def process_chains(card: str) -> dict:
    """Phase 12 (``--processes``): grids across processes over NCCL, a card
    a rank, for n = 2 and, where the machine has four cards, n = 4: a
    process group (process_group: the chained grid runs of process_runs(n)
    and the (1, n) served grid), then ``cli train --num_processes n`` at
    steps_per_dispatch 8 against 1 (mp_chain_train). NCCL takes a card a
    rank: on one card the phase only says so (the gloo runs are phase 7's
    sharded_processes and phase 8's mp_train). Returns the ranks' launch
    counts."""
    import shutil

    count = torch.cuda.device_count()
    if count < 2:
        log("process chains: NCCL takes a card a rank and this machine has one card: the NCCL "
            "runs need two or four (the gloo runs across processes: sharded_processes, mp_train)")
        return {}
    shutil.rmtree(PROCESS_DIR, ignore_errors=True)
    os.makedirs(PROCESS_DIR)
    t0 = time.perf_counter()
    counts = collections.Counter()
    for n in (2, 4) if count >= 4 else (2,):
        counts.update(process_group(card, n))
        mp_chain_train(card, n)
    log(f"process chains: {time.perf_counter() - t0:.1f} s")
    return dict(counts)


# ------------------------------------------------------------ phase 9
CHAIN = 8  # steps a dispatch: the JAX package's and its configs' default


def state_copy(state):
    """A state's tensors cloned (a chain's returned state is its graph's
    buffers, which the next replay rewrites)."""
    from sse_tpu_torch.train import loop

    return loop._with_leaves(state, [x.clone() for x in loop._state_leaves(state)], state.step)


def chain_run(card: str, label: str, s, per_step: dict, want: tuple) -> dict:
    """The train bench's setup ``s`` (bench.train_setup at chain=CHAIN):
    its first chain call (warm-up, capture, first replay) timed, with the
    memory it reserved (the graph's buffers and its pool); a replay from
    the setup's state held against CHAIN eager steps from that state (bit
    for bit where two eager runs are, else as held_state holds a state,
    the eager-vs-eager drift beside it); four replays under
    ``torch.cuda.set_sync_debug_mode("error")``; the launches a replayed
    step (``per_step``, the eager step's); ms a step chained against
    eager over the same 48 batches, each run carrying its state; the
    device's busy share of a replay (torch.profiler, ``want``: a kernel
    name every step launches). Returns the launch counts of the replays
    (reset just before them)."""
    from sse_tpu_torch import ops
    from sse_tpu_torch.train import loop

    cfg = loop.TrainConfig(batch_size=len(s.lengths), steps_per_dispatch=CHAIN,
                           loss=loop.LossConfig(kind="sampled", num_negatives=s.num_negatives))
    single = loop.make_train_step(s.model_cfg, cfg, packed_width=s.max_seq_length)
    eager = loop._eager_chain(single, CHAIN)
    pk = s.packed_variants
    args = (s.tgt_tokens, s.tgt_lens)
    e1, em = eager(s.state, pk[1], *args)
    e2, _ = eager(s.state, pk[1], *args)
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    s.chain_fn(s.state, pk[0], *args)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    pool_mib = (torch.cuda.memory_reserved() - reserved) / 2**20
    g, gm = s.chain_fn(s.state, pk[1], *args)
    g, gm = state_copy(g), {k: v.clone() for k, v in gm.items()}
    leaves = loop._state_leaves
    eager_bitwise = all(torch.equal(a, b) for a, b in zip(leaves(e1), leaves(e2)))
    if eager_bitwise:
        check(all(torch.equal(a, b) for a, b in zip(leaves(g), leaves(e1))) and all(
            torch.equal(gm[k], em[k]) for k in em), f"{label}: a replay differs from the eager "
                                                    f"steps, which are bit for bit run to run")
        held = "bit for bit (two eager runs are bit for bit)"
    else:
        drift_ = held_state(f"{label} eager against eager", e2, e1)
        got = held_state(f"{label} replay against eager", g, e1)
        for k in ("loss", "grad_norm"):
            rel = float(((gm[k] - em[k]).abs() / em[k].abs()).max())
            check(rel <= 2e-4, f"{label}: replay's {k} {rel:.3g} from the eager steps' (rtol 2e-4)")
        held = (f"held as held_state holds a state: params max |d| {got[0]:.3g}, {got[1]} "
                f"elements left out, moments {got[3]:.3g} (eager against eager: {drift_[0]:.3g}, "
                f"{drift_[1]}, {drift_[3]:.3g})")
    state = s.state
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(4):
            state, m = s.chain_fn(state, pk[i], *args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(m["loss"]).all()), f"{label}: non-finite loss {m['loss']}")

    n = 6
    ops.reset_launch_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(n):
        state, m = s.chain_fn(state, pk[i % 4], *args)
    end.record()
    torch.cuda.synchronize()
    host_chained = (time.perf_counter() - t0) * 1e3 / (n * CHAIN)
    chained = start.elapsed_time(end) / (n * CHAIN)
    counts = ops.launch_counts()
    check(all(counts[k] == v * n * CHAIN for k, v in per_step.items()),
          f"{label}: {n} replays of {CHAIN} steps launched {counts}, want {per_step} a step")
    state = s.state
    t0 = time.perf_counter()
    start.record()
    for i in range(n):
        state, _ = eager(state, pk[i % 4], *args)
    end.record()
    torch.cuda.synchronize()
    host_eager = (time.perf_counter() - t0) * 1e3 / (n * CHAIN)
    eager_ms = start.elapsed_time(end) / (n * CHAIN)
    reps = 2
    times = profiled(lambda: s.chain_fn(s.state, pk[2], *args), reps, want=want)
    busy = NOT_MEASURED if times is None else sum(
        v for k, v in times.items() if not k.startswith("sse.")) / (reps * CHAIN)
    log(f"{label} chained ({CHAIN} steps a CUDA graph): capture {capture_s:.3f} s (warm-up step, "
        f"capture, first replay), memory reserved by it {pool_mib:.1f} MiB (static buffers and "
        f"graph pool); replay against {CHAIN} eager steps from one state: {held}; 4 replays "
        f"under set_sync_debug_mode('error'); ms a step chained {chained:.4f} (host clock "
        f"{host_chained:.4f}) against eager {eager_ms:.4f} ({host_eager:.4f}), "
        f"{eager_ms / chained:.2f}x; device busy {busy:.4f} ms a step, "
        f"{100.0 * busy / chained:.1f}% of a chained step; launches a step "
        f"{ {k: counts[k] // (n * CHAIN) for k in RNN_KERNELS} } [{card}]")
    return counts


def ranking_chain_corpus():
    """(model config, task, train pairs, eval pairs, target space) of the
    ``ranking`` preset at its widths on a synthetic ranking corpus of 8,192
    pairs over 256 targets, 2 epochs, a log record and eval every 50
    steps."""
    from sse_tpu_torch import configs
    from sse_tpu_torch.data import synthetic
    from sse_tpu_torch.data.corpus import build_vocab, encode_pairs, encode_target_space

    rows, evrows, targets = synthetic.make_corpus(task="ranking", num_targets=256,
                                                  train_per_target=32, seed=SEED)
    task = configs.preset("ranking", max_epochs=2, steps_per_checkpoint=50)
    vocab = build_vocab(task.vocab_size, rows, targets,
                        max_subtoken_length=task.max_subtoken_length, vocab_mode=task.vocab_mode)
    tspace = encode_target_space(vocab, targets, task.max_seq_length)
    pairs = encode_pairs(vocab, rows, tspace, task.max_seq_length)
    mc = task.model_config(vocab.vocab_size, tspace.num_targets)
    return (mc, task, pairs, encode_pairs(vocab, evrows, tspace, task.max_seq_length), tspace)


def chain_preset(card: str) -> dict:
    """The ``ranking`` preset at its widths (GRU, E=H=D=128, 128 sampled
    and 16 mined negatives, Adam, EMA) through train() on a synthetic
    ranking corpus of 8,192 pairs (64 steps an epoch at B=128), 2 epochs,
    a log record and eval every 50 steps: once at steps_per_dispatch=8
    (chunks of 8 replayed, clamped at the checkpoints) and once at 1. The
    same log steps, finite falling loss in both, the same
    launches but for one eager warm-up step of each captured graph.
    Returns the chained run's launch counts (reset just before it)."""
    from sse_tpu_torch import ops
    from sse_tpu_torch.evals import Evaluator
    from sse_tpu_torch.train import init_train_state, train

    mc, task, pairs, evpairs, tspace = ranking_chain_corpus()
    evaluator = Evaluator(mc, evpairs, tspace)
    out, runs = {}, {}
    for k in (CHAIN, 1):
        tc = dataclasses.replace(task.train_config(), steps_per_dispatch=k)
        records = []
        state = init_train_state(mc, tc)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state = train(mc, tc, pairs, tspace, eval_fn=evaluator.evaluate, log_fn=records.append,
                      state=state)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[k] = ops.launch_counts()
        check(state.step == 128 and all(math.isfinite(r["loss"]) for r in records)
              and records[-1]["loss"] < records[0]["loss"], f"ranking K={k}: {records}")
        runs[k] = (secs, records)
    (s8, r8), (s1, r1) = runs[CHAIN], runs[1]
    check([(r["step"], r["epoch"]) for r in r8] == [(r["step"], r["epoch"]) for r in r1],
          f"ranking: log steps {r8} against {r1}")
    per_step = {n: out[1][n] / 128 for n in ("gru_fwd", "gru_bwd")}
    extra = {n: out[CHAIN][n] - out[1][n] for n in RNN_KERNELS}
    check(extra["gru_bwd"] == 2 and extra["gru_fwd"] == 2 and out[CHAIN]["gru_fwd"] > 0,
          f"ranking: launches chained {out[CHAIN]} against unchained {out[1]}: want one eager "
          f"warm-up step (2 + 2) more")
    log(f"ranking preset through train(), 128 steps (B=128, 2 epochs of 64, eval every 50): "
        f"steps_per_dispatch={CHAIN} {s8:.2f} s against 1: {s1:.2f} s (evals and the mining "
        f"refresh included), {s1 / s8:.2f}x; window loss {r8[0]['loss']:.4f} -> "
        f"{r8[-1]['loss']:.4f} (unchained {r1[0]['loss']:.4f} -> {r1[-1]['loss']:.4f}), recall@1 "
        f"{r8[-1]['recall@1']:.4f} (unchained {r1[-1]['recall@1']:.4f}); launches chained "
        f"{ {n: out[CHAIN][n] for n in ('gru_fwd', 'gru_bwd')} }, unchained "
        f"{ {n: out[1][n] for n in ('gru_fwd', 'gru_bwd')} } (a step and its evals "
        f"{per_step}), the one warm-up step of the captured graph the difference [{card}]")
    return out[CHAIN]


def chain_slice(card: str) -> dict:
    """Dispatch chaining (train.loop ``make_train_step(chain=8)``, the
    train bench's headline, train()'s chunks): chain_run on the train
    bench's GRU, the compositional recipe's towers (3-layer residual LSTM,
    dropout 0.1) and the transformer recipe's towers at the bench shape
    (E=H=D=128, B=256, 128 negatives, L=50), then chain_preset. Returns
    the launch counts of the replays and the chained train() run,
    summed."""
    from sse_tpu_torch import bench
    from sse_tpu_torch.models.towers import TowerConfig

    t0 = time.perf_counter()
    lstm = TowerConfig(vocab_size=8000, embed_dim=128, hidden=128, encoding_dim=128,
                       cell="lstm", num_layers=3, residual=True, dropout=0.1)
    counts = collections.Counter()
    for label, tower, per_step, want in (
        ("GRU train bench", None, {"gru_fwd": 2, "gru_bwd": 2}, ("gru_fwd",)),
        ("compositional train bench", lstm, {"lstm_fwd": 6, "lstm_bwd": 6, "rnn_scan": 6},
         ("rnn_scan",)),
        ("transformer train bench", transformer_config().src_tower,
         dict.fromkeys(RNN_KERNELS, 0), ()),
    ):
        s = bench.train_setup(tower=tower, chain=CHAIN)
        counts.update(chain_run(card, label, s, per_step, want))
        del s
        torch.cuda.empty_cache()
    counts.update(chain_preset(card))
    log(f"chain phase: {time.perf_counter() - t0:.1f} s")
    return dict(counts)


# ------------------------------------------------------------ phase 10
# the served query as one CUDA graph a shape: label → (model, index dtype,
# top-k variant, B); every run k=10 on a 1,249,280-row index of
# GRAPH_ROWS random unit rows made on the card
GRAPH_RUNS = {
    "GRU bf16 B=8": ("gru", torch.bfloat16, "packed", 8),
    "GRU bf16 B=256": ("gru", torch.bfloat16, "packed", 256),
    "GRU bf16 B=4096": ("gru", torch.bfloat16, "packed", 4096),
    "GRU int8 B=4096": ("gru", torch.int8, "packed", 4096),
    "GRU exact B=8": ("gru", torch.bfloat16, "exact", 8),
    "transformer B=8": ("transformer", torch.bfloat16, "packed", 8),
    "transformer B=4096": ("transformer", torch.bfloat16, "packed", 4096),
}
GRAPH_ROWS = T_PAD - 1000  # the served slices' real rows; 1,000 left for live adds
GRAPH_KERNELS = ("gru_fwd", "lstm_fwd", "rnn_scan", "topk_stream", "topk_exact", "twophase_p1",
                 "twophase_p2")


def graph_model(kind: str):
    """(config, seeded params) of the graphs phase's models at full width:
    the bench's shared-encoder 1-layer GRU, the ``transformer`` recipe's
    and the ``compositional`` recipe's (3-layer residual LSTM) models."""
    from sse_tpu_torch import configs
    from sse_tpu_torch.models import sse
    from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
    from sse_tpu_torch.models.towers import TowerConfig

    if kind == "gru":
        cfg = SSEConfig(mode=NetworkMode.SHARED_ENCODER, src_tower=TowerConfig(
            cell="gru", vocab_size=8000, embed_dim=128, hidden=128, encoding_dim=128))
    elif kind == "transformer":
        cfg = transformer_config()
    else:
        cfg = configs.preset("ranking", recipe=kind).model_config(8000, T_PAD)
    return cfg, sse.init_params(cfg, torch.Generator().manual_seed(SEED))


def uncounted(fn):
    """fn()'s result with its kernel launches left out of the counters:
    the eager calls a replay is held against and timed beside are no part
    of the main path's run."""
    from sse_tpu_torch import ops

    with ops.GraphLaunches().capturing():
        out = fn()
        torch.cuda.synchronize()
    return out


def eager_of(fn):
    """The captured function's path issued eagerly, with its signature."""
    return lambda p, e, t, l, nr=None: fn.run(p, e, t, l, fn.num_real if nr is None else nr)


def graph_run(card: str, label: str, engine, texts: list, want: str) -> dict:
    """One engine of the graphs phase after its warmup: a dispatch of the B
    texts replayed against the same call eager, bit for bit; the launches
    of one replay; ms a dispatch through ``engine.query`` (host clock,
    median) and through the function (CUDA events around back-to-back
    calls), each replayed and eager; the device's busy share of one bench
    window (``window_busy``: 32 dispatches of random full-length tokens,
    ``want`` the kernel it counts) replayed and eager. Returns the
    readings."""
    from sse_tpu_torch import bench, ops

    fn, params = engine._fused, engine.params
    emb, nr = engine.index.pub[:2]
    tokens, lengths = engine.encode_queries(texts)
    b = tokens.shape[0]
    want_out = uncounted(lambda: fn.run(params, emb, tokens, lengths, nr))
    ops.reset_launch_counts()
    got = fn(params, emb, tokens, lengths, nr)
    torch.cuda.synchronize()
    per_replay = {n: c for n, c in ops.launch_counts().items() if c}
    same(f"{label}: replay against eager", got, want_out)
    if b <= 256 and engine.pallas_variant == "packed":
        from sse_tpu_torch.models import sse

        q = uncounted(lambda: sse.encode_source(params, engine.model_cfg, tokens, lengths))
        rows_near_reference(q, emb, nr, got[1])
    reps = 20 if b <= 256 else 5
    host_graph = host_ms(lambda: engine.query(texts), reps)
    graph_fn = cuda_ms(lambda: fn(params, emb, tokens, lengths, nr), reps)
    engine._fused = eager_of(fn)
    try:
        host_eager = uncounted(lambda: host_ms(lambda: engine.query(texts), reps))
    finally:
        engine._fused = fn
    eager_fn = uncounted(lambda: cuda_ms(lambda: fn.run(params, emb, tokens, lengths, nr),
                                         reps))
    gen = torch.Generator(device="cuda").manual_seed(100)
    variants = [bench._random_tokens(gen, (b, 50), 8000, "cuda") for _ in range(4)]
    full = torch.full((b,), 50, dtype=torch.int32, device="cuda")
    setup = lambda f: bench.QuerySetup(f, params, engine.model_cfg, emb, nr, engine.k, 50,  # noqa: E731
                                       full, variants)
    wall, busy = window_busy(setup(fn), want=want)
    e_wall, e_busy = uncounted(lambda: window_busy(setup(eager_of(fn)), want=want))
    w = bench.WINDOW
    graphs = engine.last_warmup["graphs"]
    log(f"graphs {label}: replay == eager bit for bit (rows and values); launches a replay "
        f"{per_replay}; ms a dispatch replayed / eager: engine.query (host clock, median of "
        f"{reps}) {host_graph:.4f} / {host_eager:.4f}, the function (CUDA events, {reps} "
        f"back to back) {graph_fn:.4f} / {eager_fn:.4f}; a window of {w}: wall {wall:.3f} / "
        f"{e_wall:.3f} ms, device busy {busy:.3f} / {e_busy:.3f} ms "
        f"({100.0 * busy / wall:.1f}% / {100.0 * e_busy / e_wall:.1f}%); warmup "
        f"{engine.last_warmup['seconds']:.2f} s, {engine.last_warmup['captures']} captures: "
        + ", ".join(f"{g['shape']} {g['seconds']:.3f} s {g['mib']:.1f} MiB" for g in graphs)
        + f" [{card}]")
    return {"launches_a_replay": per_replay, "engine_ms": [host_graph, host_eager],
            "function_ms": [graph_fn, eager_fn], "window_ms": [wall, e_wall],
            "busy_ms": [busy, e_busy],
            "captures": [[list(g["shape"]), g["seconds"], g["mib"]] for g in graphs]}


def graph_live_index(card: str, engine, texts: list) -> dict:
    """On a served engine (one tier, B=8): 1,000 documents added in ten
    calls while another thread serves queries (no capture may happen, k is
    unchanged, each added text then ranks its own document first), then a
    delete, which copies the index buffer: its time, the recapture of the
    engine's graphs, and a replay on the new snapshot against eager."""
    stop, errors, served = threading.Event(), [], [0]

    def serve():
        try:
            while not stop.is_set():
                hits = engine.query(texts[:8])
                check(len(hits) == 8 and all(len(h) == K for h in hits), f"served {hits}")
                served[0] += 1
        except Exception as e:  # noqa: BLE001 (raised below)
            errors.append(e)

    n = len(texts)
    added = [f"{texts[i % n]} {texts[(7 * i + 3) % n]}" for i in range(1000)]
    ids = [f"added{i}" for i in range(1000)]
    before = engine.graph_counts()
    thread = threading.Thread(target=serve)
    thread.start()
    t0 = time.perf_counter()
    try:
        for lo in range(0, 1000, 100):
            engine.add_documents(ids[lo : lo + 100], added[lo : lo + 100])
    finally:
        add_s = time.perf_counter() - t0
        stop.set()
        thread.join()
    check(not errors, f"serving during the adds failed: {errors}")
    after = engine.graph_counts()
    check(after["graph_captures"] == before["graph_captures"] and engine.index.num_real == T_PAD,
          f"adds captured {after} (before {before}), num_real {engine.index.num_real}")
    for i in (0, 517, 999):
        top = engine.query([added[i]])[0][0]
        check(top["targetId"] == ids[i], f"added doc {i}: top hit {top}")
    t0 = time.perf_counter()
    engine.delete_documents(["added3", "r0", "r1"])
    delete_s = time.perf_counter() - t0
    recaptured = engine.graph_counts()["graph_captures"] - after["graph_captures"]
    check(recaptured == len(engine._bucket_widths()), f"a delete recaptured {recaptured}")
    fn, (emb, nr) = engine._fused, engine.index.pub[:2]
    tokens, lengths = engine.encode_queries(texts[:8])
    same("after the delete: replay against eager", fn(engine.params, emb, tokens, lengths, nr),
         uncounted(lambda: fn.run(engine.params, emb, tokens, lengths, nr)))
    log(f"graphs live index: 1,000 documents added in 10 calls in {add_s:.2f} s while a thread "
        f"served {served[0]} B=8 dispatches, 0 captures (k stays {engine.k}), each added text "
        f"ranks its document first; a delete of 3 took {delete_s:.3f} s (the buffer's copy and "
        f"{recaptured} captures in {engine.last_warmup['seconds']:.3f} s), then replay == eager "
        f"[{card}]")
    return {"add_s": add_s, "served_during_adds": served[0], "delete_s": delete_s,
            "recapture_s": engine.last_warmup["seconds"], "recaptures": recaptured}


def graph_http(card: str, engine, texts: list) -> None:
    """/api/stats of a warmed two-tier engine served without the
    micro-batcher: captures = tiers x buckets, and one replay more a
    dispatch (four GETs, one POST of 4,096 texts)."""
    from sse_tpu_torch.serve import serve_http

    replays = engine.graph_counts()["graph_replays"]
    server = serve_http(engine, port=free_port(), block=False, micro_batch=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        for text in texts[:4]:
            http_json(base + "/api/query?keywords=" + urllib.request.quote(text))
        http_json(base + "/api/query", {"queries": texts[:4096]})
        stats = http_json(base + "/api/stats")
    finally:
        server.shutdown()
        server.server_close()
    shapes = len(engine._batch_tiers()) * len(engine._bucket_widths())
    check(stats["graph_captures"] == shapes == stats["graphs_cached"]
          and stats["graph_replays"] == replays + 5, f"/api/stats: {stats} (from {replays})")
    log(f"graphs /api/stats: graph_captures {stats['graph_captures']} (tiers x buckets), "
        f"graph_replays {replays} -> {stats['graph_replays']} over 5 dispatches, "
        f"kernel_launches {stats['kernel_launches']} [{card}]")


def graphs_slice(card: str, corpus=None) -> tuple:
    """The served query path replayed as CUDA graphs (QueryEngine.warmup
    captures every (tier, bucket); ``build_fused_query_fn``'s
    CapturedQuery replays it): GRAPH_RUNS over the 1,249,280-row index
    (graph_run: eager against replayed, ms a dispatch, busy share, launches
    a replay, capture s and MiB a graph), /api/stats of the GRU bf16
    B=4096 engine (graph_http), one served ``compositional`` query, and
    1,000 live adds and a delete (graph_live_index). ``corpus``: the
    served slices' (vocab, target space, eval pairs); built here when
    None (vocab and eval texts only). Returns (the launch counts of the
    phase, reset at its start; the readings)."""
    from sse_tpu_torch import bench, ops
    from sse_tpu_torch.index.sharded_index import ShardedIndex
    from sse_tpu_torch.serve import QueryEngine

    t0 = time.perf_counter()
    if corpus is None:
        from sse_tpu_torch.data import synthetic
        from sse_tpu_torch.data.corpus import build_vocab

        train, evalp, targets = synthetic.make_corpus(task="ranking", num_targets=1024,
                                                      seed=SEED)
        vocab = build_vocab(8000, train, targets)
    else:
        vocab, _, evalp = corpus
    texts = [s for s, _ in evalp]
    ids = [f"r{i}" for i in range(GRAPH_ROWS)]
    rows = {dt: bench._device_index(GRAPH_ROWS, D, dt, "cuda")
            for dt in (torch.bfloat16, torch.int8)}
    check(all(e.shape[0] == T_PAD for e in rows.values()), "graph index geometry")
    models = {kind: graph_model(kind) for kind in ("gru", "transformer")}

    def engine_for(kind, dtype, variant, b):
        cfg, params = models[kind] if kind in models else graph_model(kind)
        index = ShardedIndex(emb=rows[dtype], num_real=GRAPH_ROWS, ids=list(ids),
                             texts=list(ids))
        return QueryEngine(params, cfg, vocab, index, max_seq_length=50, max_batch=8, k=K,
                           bulk_batch=b if b > 8 else None, pallas_variant=variant)

    total = collections.Counter()
    readings = {}
    for label, (kind, dtype, variant, b) in GRAPH_RUNS.items():
        ops.reset_launch_counts()
        engine = engine_for(kind, dtype, variant, b)
        engine.warmup()
        shapes = len(engine._batch_tiers()) * len(engine._bucket_widths())
        check(engine.graph_counts() == {"graph_captures": shapes, "graph_replays": 0,
                                        "graph_eager": 0,
                                        "graphs_cached": shapes}, f"{label}: warmup "
              f"{engine.graph_counts()}, want {shapes} captures")
        want = "gru_fwd" if kind == "gru" else ("wg_blockmax" if b >= 1024 else "wg_stream")
        readings[label] = graph_run(card, label, engine, (texts * 2)[:b], want)
        if label == "GRU bf16 B=4096":
            graph_http(card, engine, texts)
        total.update(ops.launch_counts())
        del engine
        torch.cuda.empty_cache()

    ops.reset_launch_counts()
    engine = engine_for("compositional", torch.bfloat16, "packed", 8)
    engine.warmup()
    tokens, lengths = engine.encode_queries(texts[:1])
    emb, nr = engine.index.pub[:2]
    fn = engine._fused
    want_out = uncounted(lambda: fn.run(engine.params, emb, tokens, lengths, nr))
    before = ops.launch_counts()
    hits = engine.query(texts[:1])[0]
    per_replay = {n: c - before[n] for n, c in ops.launch_counts().items() if c - before[n]}
    same("compositional: replay against eager", fn(engine.params, emb, tokens, lengths, nr),
         want_out)
    check(len(hits) == K and per_replay.get("lstm_fwd") == 3 and per_replay.get("rnn_scan") == 3,
          f"compositional: {hits}, launches {per_replay}")
    log(f"graphs compositional (3-layer residual LSTM): one served query replayed, == eager bit "
        f"for bit; launches a replay {per_replay}; warmup {engine.last_warmup['seconds']:.2f} s, "
        + ", ".join(f"{g['shape']} {g['seconds']:.3f} s {g['mib']:.1f} MiB"
                    for g in engine.last_warmup["graphs"]) + f" [{card}]")
    total.update(ops.launch_counts())
    del engine

    ops.reset_launch_counts()
    engine = engine_for("gru", torch.bfloat16, "packed", 8)
    engine.warmup()
    readings["live index"] = graph_live_index(card, engine, texts)
    total.update(ops.launch_counts())
    del engine, rows
    torch.cuda.empty_cache()
    log(f"graphs phase: {time.perf_counter() - t0:.1f} s")
    return dict(total), readings


# ------------------------------------------------------------ phase 11
# the Evaluator's and the index build's programs as CUDA graphs: the bench
# tower over EVAL_ROWS random target texts, the qna model over QNA_ROWS
EVAL_ROWS = T_PAD
QNA_ROWS = 262_144
EVAL_SOURCES = 4096
EVAL_KERNELS = ("gru_fwd", "lstm_fwd", "rnn_scan")


def eval_data(t: int, n: int, seed: int = SEED):
    """(target space, eval pairs): ``t`` target texts and ``n`` eval
    sources of random token ids at L=50 (lengths 8-50) from a seeded numpy
    generator, one label each."""
    from sse_tpu_torch.data.corpus import EncodedPairs, TargetSpace

    rng = np.random.default_rng(seed)

    def tokens(m):
        lens = rng.integers(8, 51, size=(m,), dtype=np.int32)
        toks = rng.integers(2, 8000, size=(m, 50), dtype=np.int32)
        toks[np.arange(50)[None, :] >= lens[:, None]] = 0
        return toks, lens

    toks, lens = tokens(t)
    ids = [f"r{i}" for i in range(t)]
    tspace = TargetSpace(ids=ids, texts=ids, tokens=toks, lengths=lens, id_to_row={})
    src, src_len = tokens(n)
    labels = rng.integers(0, t, size=(n,), dtype=np.int32)
    return tspace, EncodedPairs(src=src, src_len=src_len, labels=labels,
                                label_sets=[(int(x),) for x in labels])


def nudged(params, seed: int):
    """Params of the same shapes with other values (a later checkpoint's)."""
    from sse_tpu_torch.train.loop import tree_map

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tree_map(lambda x: x + 0.01 * torch.randn(x.shape, generator=gen, device="cuda"),
                    params)


def synced_s(fn):
    """(fn()'s result, host seconds to its completion on the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def eval_run(card: str, label: str, cfg, params, tspace, pairs) -> dict:
    """One Evaluator replayed against the same Evaluator eager
    (``capture=False``): the first ``evaluate`` captures 2 graphs, a
    second with other param values none; its target embeddings and top
    rows equal eager's bit for bit; ``encode_targets`` and ``top_rows``
    (given the targets) timed replayed and eager (host clock to
    completion, after the checked call); the graphs' seconds and MiB."""
    from sse_tpu_torch.evals import Evaluator

    t, n = tspace.num_targets, pairs.num_examples
    ev = Evaluator(cfg, pairs, tspace, ks=(1, 10))
    eager = Evaluator(cfg, pairs, tspace, ks=(1, 10), capture=False)
    first, first_s = synced_s(lambda: ev.evaluate(params))
    check(ev.graph_stats.counts()["graph_captures"] == 2, f"{label}: {ev.graph_stats.counts()}")
    other = nudged(params, 7)
    rows, second_s = synced_s(lambda: ev.top_rows(other))
    emb = ev.encode_targets(other)
    check(ev.graph_stats.counts()["graph_captures"] == 2,
          f"{label}: the second evaluate captured: {ev.graph_stats.counts()}")
    want_emb = uncounted(lambda: eager.encode_targets(other))
    check(torch.equal(emb, want_emb), f"{label}: target embeddings replayed != eager")
    want_rows = uncounted(lambda: eager.top_rows(other, want_emb))
    check(np.array_equal(rows, want_rows) and rows.shape == (n, 10),
          f"{label}: top rows replayed != eager at {np.argwhere(rows != want_rows)[:5]}")
    check(np.all((rows >= 0) & (rows < t)), f"{label}: rows out of range")
    _, enc_s = synced_s(lambda: ev.encode_targets(other))
    _, enc_eager_s = uncounted(lambda: synced_s(lambda: eager.encode_targets(other)))
    _, top_s = synced_s(lambda: ev.top_rows(other, emb))  # emb: its own buffer, not copied
    _, top_eager_s = uncounted(lambda: synced_s(lambda: eager.top_rows(other, want_emb)))
    graphs = list(ev.graph_stats.log)
    mib = sum(g["mib"] for g in graphs)
    log(f"evals {label} ({t:,} targets, {n:,} sources, batch 256): replay == eager bit for bit "
        f"(targets and top rows); first evaluate {first_s:.2f} s (2 captures: "
        + ", ".join(f"{g['shape'][0]} {g['seconds']:.3f} s {g['mib']:.1f} MiB" for g in graphs)
        + f"), recall@1 {first['recall@1']:.4f}; a second with other params {second_s:.2f} s, "
        f"0 captures; encode_targets replayed / eager {enc_s * 1e3:.1f} / {enc_eager_s * 1e3:.1f}"
        f" ms ({t / enc_s:,.0f} / {t / enc_eager_s:,.0f} docs/s); top_rows given the targets "
        f"{top_s * 1e3:.1f} / {top_eager_s * 1e3:.1f} ms [{card}]")
    return {"targets": t, "sources": n, "first_evaluate_s": first_s,
            "second_evaluate_s": second_s, "captures": [2, 0],
            "encode_targets_ms": [enc_s * 1e3, enc_eager_s * 1e3],
            "encode_docs_per_s": [t / enc_s, t / enc_eager_s],
            "top_rows_ms": [top_s * 1e3, top_eager_s * 1e3], "pool_mib": mib,
            "graphs": [[g["shape"][0], g["seconds"], g["mib"]] for g in graphs]}


def index_run(card: str, label: str, cfg, params, tspace) -> dict:
    """build_index (bf16, 64 x 256-row chunks) replayed against eager:
    the buffers equal bit for bit, the reserve rows zero, one capture and
    a replay a further chunk, JAX's progress calls; docs/s each way, the
    capture's seconds and MiB."""
    from sse_tpu_torch.index import build_index
    from sse_tpu_torch.utils.graphs import GraphStats

    t = tspace.num_targets
    stats, calls = GraphStats(), []
    kw = dict(batch_size=256, dtype=torch.bfloat16, chunk_batches=64)
    idx, s = synced_s(lambda: build_index(params, cfg, tspace, graph_stats=stats,
                                          progress=lambda *a: calls.append(a), **kw))
    want, eager_s = uncounted(lambda: synced_s(lambda: build_index(params, cfg, tspace,
                                                                   capture=False, **kw)))
    chunks = -(-t // 16384)
    check(torch.equal(idx.emb, want.emb) and not idx.emb[t:].any(),
          f"{label}: index replayed != eager")
    check(stats.counts() == {"graph_captures": 1, "graph_replays": chunks - 1, "graph_eager": 0}
          and calls == [(min(hi, t), t) for hi in range(16384, t + 16384, 16384)],
          f"{label}: {stats.counts()}, progress {calls[:3]}...")
    check(bool(torch.isfinite(idx.emb[:t].float()).all()), f"{label}: non-finite rows")
    g = stats.log[-1]
    log(f"index {label} ({t:,} targets, bf16, {chunks} chunks of 64 x 256): replayed == eager "
        f"bit for bit, reserve rows zero; {s:.2f} s ({t / s:,.0f} docs/s, the capture included: "
        f"{g['seconds']:.3f} s, {g['mib']:.1f} MiB) against eager {eager_s:.2f} s "
        f"({t / eager_s:,.0f} docs/s) [{card}]")
    return {"targets": t, "chunks": chunks, "docs_per_s": [t / s, t / eager_s],
            "seconds": [s, eager_s], "capture_s": g["seconds"], "capture_mib": g["mib"]}


def eval_preset(card: str) -> dict:
    """The ``ranking`` preset through train() at steps_per_dispatch 8 (as
    chain_preset runs it) with the Evaluator's programs replayed, against
    the same run with them eager: the same log steps, finite falling
    loss, seconds each. Returns the readings; the replayed run is the
    last, so its launches are what the caller reads after it."""
    from sse_tpu_torch import ops
    from sse_tpu_torch.evals import Evaluator
    from sse_tpu_torch.train import init_train_state, train

    mc, task, pairs, evpairs, tspace = ranking_chain_corpus()
    tc = dataclasses.replace(task.train_config(), steps_per_dispatch=CHAIN)
    runs = {}
    for capture in (False, True):
        evaluator = Evaluator(mc, evpairs, tspace, capture=capture)
        records = []
        state = init_train_state(mc, tc)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state = train(mc, tc, pairs, tspace, eval_fn=evaluator.evaluate, log_fn=records.append,
                      state=state)
        torch.cuda.synchronize()
        runs[capture] = (time.perf_counter() - t0, records, evaluator.graph_stats.counts())
        check(state.step == 128 and all(math.isfinite(r["loss"]) for r in records)
              and records[-1]["loss"] < records[0]["loss"], f"ranking evals {capture}: {records}")
    (se, re, _), (sr, rr, graphs) = runs[False], runs[True]
    check([r["step"] for r in re] == [r["step"] for r in rr] and graphs["graph_captures"] == 2,
          f"ranking evals: {re} against {rr}, graphs {graphs}")
    log(f"ranking preset through train() at steps_per_dispatch={CHAIN}, 128 steps, an eval every "
        f"50 steps and at the end: evals replayed {sr:.2f} s against eager {se:.2f} s "
        f"({se / sr:.2f}x); the Evaluator's graphs {graphs}; recall@1 {rr[-1]['recall@1']:.4f} "
        f"(eager evals {re[-1]['recall@1']:.4f}) [{card}]")
    return {"seconds": [sr, se], "graphs": graphs}


FLAG_NAMES = ("matmul.allow_tf32", "matmul.allow_bf16_reduced_precision_reduction",
              "cudnn.allow_tf32")


def set_flags() -> None:
    """The precision flags main sets (ROADMAP's precision policy)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False


def flags_probe() -> None:
    """Run in a fresh process (``--flags-probe``) with PyTorch's default
    flags: ``_TensorCoreDot`` forward and backward, a served transformer
    query (B=8 and 4096, replayed) and an Evaluator replay (transformer and
    GRU towers), then the same calls anew under ``set_flags``; prints one
    JSON line: the default flags and, for each call, whether every bit
    matched."""
    from sse_tpu_torch.evals import Evaluator
    from sse_tpu_torch.models import sse, towers
    from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
    from sse_tpu_torch.models.towers import TowerConfig
    from sse_tpu_torch.serve.engine import build_fused_query_fn

    defaults = {
        "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "matmul.allow_bf16_reduced_precision_reduction":
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    tcfg = transformer_config()
    gcfg = SSEConfig(mode=NetworkMode.SHARED_ENCODER, src_tower=TowerConfig(
        cell="gru", vocab_size=8000, embed_dim=128, hidden=128, encoding_dim=128))
    tparams = sse.init_params(tcfg, torch.Generator().manual_seed(SEED))
    gparams = sse.init_params(gcfg, torch.Generator().manual_seed(SEED))
    tspace, pairs = eval_data(16384, 1024, SEED + 3)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    a = torch.randn((256 * 50, 128), generator=gen, device="cuda")
    w = torch.randn((128, 512), generator=gen, device="cuda")
    g = torch.randn((256 * 50, 512), generator=gen, device="cuda")
    emb = unit_rows(65536, gen).to(torch.bfloat16)
    toks = {b: torch.randint(2, 8000, (b, 50), generator=gen, device="cuda", dtype=torch.int32)
            for b in (8, 4096)}
    full = {b: torch.full((b,), 50, dtype=torch.int32, device="cuda") for b in (8, 4096)}

    def calls():
        x, y = a.clone().requires_grad_(), w.clone().requires_grad_()
        out = towers._TensorCoreDot.apply(x, y)
        dx, dy = torch.autograd.grad(out, (x, y), g)
        fused = build_fused_query_fn(tcfg, K, 65536)
        served = [fused(tparams, emb, toks[b], full[b]) for b in (8, 4096)]
        served += [fused(tparams, emb, toks[b], full[b]) for b in (8, 4096)]  # replays
        evs = {}
        for name, cfg, params in (("transformer", tcfg, tparams), ("gru", gcfg, gparams)):
            ev = Evaluator(cfg, pairs, tspace)
            ev.evaluate(params)
            evs[name] = (ev.top_rows(params), ev.encode_targets(params).clone())
        torch.cuda.synchronize()
        return {"_TensorCoreDot forward": [out.detach()],
                "_TensorCoreDot backward": [dx, dy],
                "served transformer query B=8 / 4096": [t for vr in served for t in vr],
                "Evaluator replay, transformer": [torch.from_numpy(evs["transformer"][0]),
                                                  evs["transformer"][1]],
                "Evaluator replay, GRU": [torch.from_numpy(evs["gru"][0]), evs["gru"][1]]}

    base = calls()
    set_flags()
    flagged = calls()
    same_bits = {k: all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(base[k], flagged[k]))
                 for k in base}
    print(json.dumps({"flags_probe": {"defaults": defaults, "same": same_bits}}))


def flags_check(card: str) -> dict:
    """ROADMAP §3 open check 1: ``flags_probe`` in a fresh process; logs
    and returns which calls kept every bit under the flags main sets."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--flags-probe"],
                          capture_output=True, text=True, timeout=300)
    line = next((ln for ln in reversed(proc.stdout.splitlines()) if '"flags_probe"' in ln), None)
    check(proc.returncode == 0 and line is not None,
          f"flags probe exited {proc.returncode}: {proc.stderr[-2000:]}")
    got = json.loads(line)["flags_probe"]
    log(f"precision flags: PyTorch's defaults {got['defaults']}; bit for bit the same under "
        f"{FLAG_NAMES} off: {got['same']} [{card}]")
    return got


def evals_slice(card: str) -> tuple:
    """The Evaluator's and the index build's programs as CUDA graphs: the
    bench tower (shared-encoder GRU, E=H=D=128) over EVAL_ROWS random
    target texts and EVAL_SOURCES eval sources (eval_run, index_run), the
    qna model (dual-encoder LSTM, attention readout) over QNA_ROWS, the
    ranking preset through train() with replayed evals against eager ones
    (eval_preset), the index bench (replayed and eager), and the
    precision flags' check (flags_check). Returns (the launch counts of
    the phase, reset at its start; the readings)."""
    from sse_tpu_torch import bench, ops

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    readings = {}
    gcfg, gparams = graph_model("gru")
    tspace, pairs = eval_data(EVAL_ROWS, EVAL_SOURCES)
    readings["GRU Evaluator"] = eval_run(card, "GRU", gcfg, gparams, tspace, pairs)
    readings["GRU index"] = index_run(card, "GRU", gcfg, gparams, tspace)
    total = collections.Counter(ops.launch_counts())
    del tspace, pairs
    torch.cuda.empty_cache()

    ops.reset_launch_counts()
    from sse_tpu_torch.models import sse

    qcfg = qna_config()
    qparams = sse.init_params(qcfg, torch.Generator().manual_seed(SEED))
    tspace, pairs = eval_data(QNA_ROWS, EVAL_SOURCES, SEED + 1)
    readings["qna Evaluator"] = eval_run(card, "qna", qcfg, qparams, tspace, pairs)
    readings["qna index"] = index_run(card, "qna", qcfg, qparams, tspace)
    counts = ops.launch_counts()
    check(counts["lstm_fwd"] > 0 and counts["rnn_scan"] > 0, f"qna evals: launches {counts}")
    total.update(counts)
    del tspace, pairs
    torch.cuda.empty_cache()

    ops.reset_launch_counts()
    readings["ranking preset"] = eval_preset(card)
    total.update(ops.launch_counts())
    ops.reset_launch_counts()
    result = bench.run_index_bench(seconds=1.0)
    check(result["value"] > 0 and result["docs_per_sec_eager"] > 0, f"index bench {result}")
    log(f"index bench (B=512, L=50): replayed {result['value']:,.1f} docs/s "
        f"({result['ms_per_batch']} ms), eager {result['docs_per_sec_eager']:,.1f} "
        f"({result['ms_per_batch_eager']} ms) [{card}]")
    readings["index bench"] = result
    total.update(ops.launch_counts())
    readings["flags"] = flags_check(card)
    log(f"evals phase: {time.perf_counter() - t0:.1f} s")
    return dict(total), readings


# ------------------------------------------------------------ the wide layers
# The recurrent widths the JAX package trains beyond E=H=128 (ops/rnn.py
# layer_plan): the cluster instances of the scan and of the dh loops, the
# GRU forward's split route, zero-padded odd widths.
WIDE_KERNELS = {  # name → (source, the TPU kernel it replaces)
    "gru_fwd_split": ("sse_tpu_torch/csrc/rnn_scan.cu", "sse_tpu/ops/pallas_rnn.py:337"),
    "rnn_scan_cluster": ("sse_tpu_torch/csrc/rnn_scan.cu", "sse_tpu/ops/pallas_rnn.py:102"),
    "gru_bwd_cluster": ("sse_tpu_torch/csrc/gru_bwd.cu", "sse_tpu/ops/pallas_rnn.py:384"),
    "lstm_bwd_cluster": ("sse_tpu_torch/csrc/lstm_bwd.cu", "sse_tpu/ops/pallas_rnn.py:384"),
}
WIDE_H = (256, 384)
SCAN_PARTS = {"rnn_scan_": "scan", "gates_product_kernel": "x-product"}


def glorot_weights(E: int, H: int, G: int, gen):
    """Wx, Wh (bf16) and b of a G-gate layer drawn as the towers initialize
    them (towers.py ``_glorot``: std sqrt(2 / (fan_in + fan_out))), so a
    check at H=384 sees the pre-activations a model of that width starts
    from (layer_weights' fixed 0.08 is H=128's scale)."""
    wx = (torch.randn((E, G * H), generator=gen, device="cuda")
          * math.sqrt(2.0 / (E + G * H))).bfloat16()
    wh = (torch.randn((H, G * H), generator=gen, device="cuda")
          * math.sqrt(2.0 / (H + G * H))).bfloat16()
    b = torch.randn((G * H,), generator=gen, device="cuda") * 0.05
    return wx, wh, b


def wide_fwd(card: str, cell: str, H: int, B: int, gen, T: int = 50, E: int = 128) -> dict:
    """The split layer forward (the x-product, then the cluster scan) of
    ``cell`` at (E, H), B rows, T=50, ragged lengths, Glorot weights
    (glorot_weights): held against the
    plain version (hold_layer); its time (CUDA events), device time by
    part, the plain version's time, cuDNN's LSTM at the same shape (the
    LSTM's library time; beside the GRU, whose function cuDNN's GRU does
    not compute, a yardstick only), the bound, and the scan's tile
    (scan_tile_reading). Returns the row's readings."""
    from sse_tpu_torch.ops import rnn

    G = 4 if cell == "lstm" else 3
    wx, wh, b = glorot_weights(E, H, G, gen)
    xs = torch.randn((T, B, E), generator=gen, device="cuda").bfloat16()
    args = (xs, ragged_mask(T, B, gen), wx, wh, b)
    plan = rnn.layer_plan(cell, E, H)
    before = dict(rnn.launches)
    if cell == "lstm":
        ys, fin, cs, _ = rnn.rnn_fwd_launch(*args, "lstm", cluster=plan.scan_cluster)
        got = (ys, fin, cs)
    else:
        got = rnn.rnn_layer(*args)
    torch.cuda.synchronize()
    check(rnn.launches["rnn_scan_cluster"] == before["rnn_scan_cluster"] + 1,
          f"{cell} forward H={H}: launches {rnn.launches} from {before}")
    want = rnn.rnn_layer_reference(*args, cell)
    e, e_b, flips = hold_layer(f"{cell} forward H={H} B={B}", got, want[:len(got)])
    run = lambda: rnn.rnn_layer(*args, cell=cell)  # noqa: E731
    ms = cuda_ms(run)
    dev = parts_ms(run, SCAN_PARTS)
    plain = cuda_ms(lambda: rnn.rnn_layer_reference(*args, cell), reps=2)
    lib = None
    yardstick = torch.Generator(device="cuda").manual_seed(SEED + 23)  # leaves gen's draws
    lstm = cudnn_lstm(*(glorot_weights(E, H, 4, yardstick) if cell == "gru" else (wx, wh, b)))

    def cudnn_call():
        with torch.no_grad():
            return lstm(xs)

    cudnn = cuda_ms(cudnn_call)
    calls = call_device_ms({"ours": run, "cudnn": cudnn_call})
    if cell == "lstm":
        lib = cudnn
    tile = scan_tile_reading(cell, H, B, plan)
    moved = nbytes(*args, *got)
    bnd = bound(moved, 2.0 * T * B * (E + H) * G * H)
    log(f"{cell} forward (split, scan on {tile['C']} blocks x {tile['R']} rows a cluster, "
        f"{tile['clusters']} clusters in {tile['waves']} waves of {tile['active']}, the "
        f"clusters the card holds at once) T={T} B={B} E={E} H={H}: "
        f"fin max_abs_err {e:.3g}, {flips} bf16 values differ (max {e_b:.3g}, one ulp); kernel "
        f"{ms:.4f} ms (device {sum(dev.values()):.4f}: scan {dev['scan']:.4f}, x-product "
        f"{dev['x-product']:.4f}), plain {plain:.4f} ms, cuDNN LSTM (full lengths"
        + ("" if cell == "lstm" else ", an LSTM's function: a yardstick only")
        + f") {cudnn:.4f} ms; device time of every kernel of a call, the two in turns in one "
        f"profiler session: ours {calls['ours']:.4f}, cuDNN {calls['cudnn']:.4f} ms; bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) [{card}]")
    return dict(ms=ms, device_ms=sum(dev.values()), cuda_kernels=dev, plain_ms=plain,
                library_ms=lib, cudnn_lstm_ms=cudnn, call_device_ms=calls["ours"],
                cudnn_lstm_device_ms=calls["cudnn"], max_abs_err=max(e, e_b), B=B, H=H, E=E,
                T=T, clusters=tile["C"], tile=tile, **bnd)


def scan_tile_reading(cell: str, H: int, B: int, plan) -> dict:
    """The tile the cluster scan takes for B rows at the plan's widths
    (rnn.card_scan_tile: blocks a cluster C, rows a cluster R, clusters,
    the card's active clusters from cudaOccupancyMaxActiveClusters, waves)."""
    from sse_tpu_torch.ops import rnn

    G = 4 if cell == "lstm" else 3
    dev = torch.device("cuda", torch.cuda.current_device())
    return rnn.card_scan_tile(dev, G, plan.H_p, B, plan.scan_cluster)._asdict()


def wide_bwd(card: str, cell: str, H: int, B: int, gen, T: int = 50, E: int = 128) -> dict:
    """The layer backward whose dh loop runs on the cluster instance, at
    (E, H), B rows, T=50, Glorot weights, fed the kernels' forward: held as check_bwd
    holds it end to end (dWx, dWh, db to 1e-3 of max-abs; dxs to one ulp
    plus 1e-4 of max-abs at the loop's first step, 1e-2 over all steps);
    its time, device time by kernel, the plain version's, cuDNN's LSTM
    backward (LSTM only: CUDA events, and the device time of every kernel
    of a call of each, the two in turns in one profiler session), the
    bound and the dh loop's tile (dh_tile_reading). Returns the row's
    readings."""
    from sse_tpu_torch.ops import rnn

    lstm = cell == "lstm"
    G = 4 if lstm else 3
    wx, wh, b = glorot_weights(E, H, G, gen)
    xs = torch.randn((T, B, E), generator=gen, device="cuda").bfloat16()
    mask = ragged_mask(T, B, gen)
    plan = rnn.layer_plan(cell, E, H)
    if lstm:
        ys, _, cs, _ = rnn.rnn_fwd_launch(xs, mask, wx, wh, b, "lstm", cluster=plan.scan_cluster)
    else:
        (ys, _), cs = rnn.rnn_layer(xs, mask, wx, wh, b), None
    dys = (torch.randn((T, B, H), generator=gen, device="cuda") * 0.1).bfloat16()
    dfin = torch.randn((B, H), generator=gen, device="cuda")
    args = (xs, ys, mask, wx, wh, b, dys, dfin)
    run = lambda: rnn.rnn_layer_bwd(*args, cs=cs, cell=cell)  # noqa: E731
    before = dict(rnn.launches)
    got = run()
    torch.cuda.synchronize()
    check(rnn.launches[f"{cell}_bwd_cluster"] == before[f"{cell}_bwd_cluster"] + 1,
          f"{cell} backward H={H}: launches {rnn.launches} from {before}")
    want = rnn.rnn_layer_bwd_reference(*args, cs, cell)
    gx, wx_ = got[0].float(), want[0].float()
    torch.testing.assert_close(gx[-1], wx_[-1], atol=1e-4 * float(wx_.abs().max()),
                               rtol=2.0**-7)
    rels, err = {}, 0.0
    for part, g, w in zip(("dxs", "dwx", "dwh", "db"), got, want):
        e = float((g.float() - w.float()).abs().max())
        rels[part] = e / max(float(w.float().abs().max()), 1e-30)
        check(rels[part] <= (1e-2 if part == "dxs" else 1e-3),
              f"{cell} backward H={H} B={B} {part}: {rels[part]:.3g} of max-abs")
        err = max(err, e)
    ms = cuda_ms(run)
    split = bwd_split(run, cell)
    plain = cuda_ms(lambda: rnn.rnn_layer_bwd_reference(*args, cs, cell), reps=2)
    lib = calls = None
    if lstm:
        lstm_mod = cudnn_lstm(wx, wh, b)
        x_l = xs.clone().requires_grad_(True)
        y_l, _ = lstm_mod(x_l)
        inputs = [x_l, *lstm_mod.parameters()]
        cudnn = lambda: torch.autograd.grad(y_l, inputs, dys, retain_graph=True)  # noqa: E731
        lib = cuda_ms(cudnn)
        calls = call_device_ms({"ours": run, "cudnn": cudnn})
    tile = dh_tile_reading(cell, H, B, plan)
    bnd = bound(nbytes(*args, *([cs] if lstm else []), *got), 2.0 * T * B * G * H * 3 * (E + H))
    log(f"{cell} backward (dh loop on {tile['C']} blocks x {tile['R']} rows a cluster, "
        f"{tile['clusters']} clusters in {tile['waves']} waves of {tile['active']}) T={T} B={B} "
        f"E={E} H={H}: " + ", ".join(f"{k} {v:.2g} of max-abs" for k, v in rels.items())
        + f"; kernel {ms:.4f} ms (device by kernel {json.dumps(split)}), plain {plain:.4f} ms"
        + (f", cuDNN LSTM backward (full lengths) {lib:.4f} ms; device time of every kernel of "
           f"a call, the two in turns in one profiler session: ours {calls['ours']:.4f}, cuDNN "
           f"{calls['cudnn']:.4f} ms" if lib is not None else "")
        + f"; bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) [{card}]")
    return dict(ms=ms, device_ms=sum(split.values()), cuda_kernels=split, plain_ms=plain,
                library_ms=lib, cudnn_lstm_ms=lib,
                call_device_ms=calls["ours"] if calls else None,
                cudnn_lstm_device_ms=calls["cudnn"] if calls else None, max_abs_err=err,
                rel_err=rels, B=B, H=H, E=E, T=T, clusters=plan.dh_cluster, tile=tile, **bnd)


def dh_tile_reading(cell: str, H: int, B: int, plan) -> dict:
    """The tile the cluster dh loop takes for B rows at the plan's widths
    (rnn.card_dh_tile, as scan_tile_reading gives the scan's)."""
    from sse_tpu_torch.ops import rnn

    G = 4 if cell == "lstm" else 3
    dev = torch.device("cuda", torch.cuda.current_device())
    return rnn.card_dh_tile(dev, G, plan.H_p, B, plan.dh_cluster)._asdict()


WIDE_KEYS = ("ms", "device_ms", "plain_ms", "library_ms", "max_abs_err", "bound_ms", "bound_by",
             "B", "clusters", "tile", "cudnn_lstm_ms", "call_device_ms", "cudnn_lstm_device_ms")


def check_wide(card: str, results: dict) -> None:
    """The kernels line's rows of the wide instances, at H=256 (the row)
    and H=384 (its ``at_384``), T=50, E=128: the GRU's split forward and
    the LSTM forward's cluster scan at B=4096 (the served bulk tier), the
    GRU backward at B=384 and the LSTM's at B=256 (the train bench's
    target and source towers; at B=4096 too, the backwards' ``at_4096``
    and ``at_384_4096``), as the H=128 rows measure them. Each row carries
    its cluster launch's tile (C, R, waves) and the LSTM's cuDNN's LSTM at
    the same shape; the LSTM's at H=256 are logged against cuDNN's, CUDA
    events against events and device time against device time
    (call_device_ms)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    t0 = time.perf_counter()
    for H in WIDE_H:
        rows = {"gru_fwd_split": wide_fwd(card, "gru", H, 4096, gen),
                "rnn_scan_cluster": wide_fwd(card, "lstm", H, 4096, gen),
                "gru_bwd_cluster": wide_bwd(card, "gru", H, 384, gen),
                "lstm_bwd_cluster": wide_bwd(card, "lstm", H, 256, gen)}
        bulk = {"gru_bwd_cluster": wide_bwd(card, "gru", H, 4096, gen),
                "lstm_bwd_cluster": wide_bwd(card, "lstm", H, 4096, gen)}
        at = "" if H == WIDE_H[0] else f"_{H}"
        for name, row in rows.items():
            if H == WIDE_H[0]:
                results[name].update(row)
            else:
                results[name][f"at{at}"] = {k: row[k] for k in WIDE_KEYS if k in row}
        for name, row in bulk.items():
            results[name][f"at{at}_4096"] = {k: row[k] for k in WIDE_KEYS if k in row}
        torch.cuda.empty_cache()
    row = results["rnn_scan_cluster"]
    log(f"LSTM forward H=256 B=4096 T=50 against cuDNN's torch.nn.LSTM in this run: CUDA "
        f"events {row['ms']:.4f} / {row['library_ms']:.4f} ms "
        f"({row['ms'] / row['library_ms']:.2f}x); device, every kernel of a call in one "
        f"profiler session, {row['call_device_ms']:.4f} / {row['cudnn_lstm_device_ms']:.4f} ms "
        f"({row['call_device_ms'] / row['cudnn_lstm_device_ms']:.2f}x; our scan + x-product "
        f"{row['device_ms']:.4f}) [{card}]")
    bwd = results["lstm_bwd_cluster"]
    for label, row in (("B=256", bwd), ("B=4096", bwd["at_4096"])):
        log(f"LSTM backward H=256 {label} T=50 against cuDNN's torch.nn.LSTM backward in this "
            f"run: CUDA events {row['ms']:.4f} / {row['cudnn_lstm_ms']:.4f} ms "
            f"({row['ms'] / row['cudnn_lstm_ms']:.2f}x); device, every kernel of a call in one "
            f"profiler session, {row['call_device_ms']:.4f} / {row['cudnn_lstm_device_ms']:.4f} "
            f"ms ({row['call_device_ms'] / row['cudnn_lstm_device_ms']:.2f}x; our kernels by "
            f"name {row['device_ms']:.4f}) [{card}]")
    log(f"wide kernel checks: {time.perf_counter() - t0:.1f} s")


def wide_costs(card: str, Bs=(8, 256, 4096), Ts=(1, 2, 50)) -> None:
    """The recurrences' cost a step at H=256 (the cluster instances) beside
    H=128 (the fixed ones), from the kernels' torch.profiler device time
    at T=1, 2, 50 (slope_line): the scan of each cell (scan_layer over a
    precomputed ax) and each cell's dh loop (the backward's dh kernel
    alone), full lengths, E=128, each cluster launch with its tile."""
    from sse_tpu_torch.ops import rnn

    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    for cell, G in (("gru", 3), ("lstm", 4)):
        for H in (128, 256):
            plan = rnn.layer_plan(cell, 128, H)
            wx, wh, b = layer_weights(128, H, G, gen)
            for B in Bs:
                scan, dh = {}, {}
                for T in Ts:
                    ax = torch.randn((T, B, G * H), generator=gen, device="cuda")
                    mask = torch.ones((T, 1, B), device="cuda")
                    scan[T] = kernel_ms(lambda: rnn.scan_layer(ax, mask, wh, cell), "rnn_scan_")
                    xs = torch.randn((T, B, 128), generator=gen, device="cuda").bfloat16()
                    ys, _, cs = rnn._scan_reference(rnn._x_product(xs, wx, b), mask, wh, cell)
                    dys = (torch.randn((T, B, H), generator=gen, device="cuda") * 0.1).bfloat16()
                    dfin = torch.randn((B, H), generator=gen, device="cuda")
                    dh[T] = kernel_ms(lambda: rnn.rnn_layer_bwd(xs, ys, mask, wx, wh, b, dys, dfin,
                                                                cs, cell), f"{cell}_bwd_dh_")
                where, dh_where = f"{plan.scan_cluster} blocks", f"{plan.dh_cluster} blocks"
                if plan.scan_cluster > 1:
                    t = scan_tile_reading(cell, H, B, plan)
                    where = (f"{t['C']} blocks x {t['R']} rows, {t['waves']} waves of "
                             f"{t['active']}")
                if plan.dh_cluster > 1:
                    t = dh_tile_reading(cell, H, B, plan)
                    dh_where = (f"{t['C']} blocks x {t['R']} rows, {t['waves']} waves of "
                                f"{t['active']}")
                log(slope_line(f"{cell} scan H={H} ({where}) B={B}", scan)
                    + "; " + slope_line(f"dh loop ({dh_where})", dh) + f" [{card}]")


class OnTheKernels:
    """Inside it, a recurrent layer that ran its plain version on a card
    fails the run: the plain forward and backward raise on CUDA tensors."""

    def __enter__(self):
        from sse_tpu_torch.ops import rnn

        self.saved = rnn._scan_reference, rnn.rnn_layer_bwd_reference

        def guard(fn):
            def run(*args, **kw):
                if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                    raise AssertionError(f"a recurrent layer ran {fn.__name__} on the card")
                return fn(*args, **kw)
            return run

        rnn._scan_reference, rnn.rnn_layer_bwd_reference = (guard(f) for f in self.saved)
        return self

    def __exit__(self, *exc):
        from sse_tpu_torch.ops import rnn

        rnn._scan_reference, rnn.rnn_layer_bwd_reference = self.saved


def wide_train(card: str, label: str, task_name: str, need: tuple, epochs: int,
               recipe: str | None = None, serve: bool = False, **widths) -> dict:
    """A task preset at other widths (``widths``: TaskConfig overrides)
    trained through train() for ``epochs`` epochs of its demo corpus (5
    steps an epoch, a log record and eval every half of them) with the
    Evaluator as eval_fn, inside OnTheKernels; its counters in ``need``
    must be > 0, its loss finite and, from 10 epochs on, falling.
    ``serve``: its EMA params then serve one query through QueryEngine,
    twice, the second a replay of the captured graph, held against
    topk_reference. Returns the training run's launch counts."""
    from sse_tpu_torch import configs, ops
    from sse_tpu_torch.data import synthetic
    from sse_tpu_torch.data.corpus import build_vocab, encode_pairs, encode_target_space
    from sse_tpu_torch.evals import Evaluator
    from sse_tpu_torch.index import build_index
    from sse_tpu_torch.ops import rnn
    from sse_tpu_torch.serve import QueryEngine
    from sse_tpu_torch.train import inference_params, init_train_state, train

    task = configs.preset(task_name, recipe=recipe, max_epochs=epochs,
                          steps_per_checkpoint=5 * epochs // 2, **widths)
    rows, evrows, targets = synthetic.make_corpus(task=task_name, seed=SEED)
    vocab = build_vocab(task.vocab_size, rows, targets,
                        max_subtoken_length=task.max_subtoken_length, vocab_mode=task.vocab_mode)
    tspace = encode_target_space(vocab, targets, task.max_seq_length)
    pairs = encode_pairs(vocab, rows, tspace, task.max_seq_length)
    evpairs = encode_pairs(vocab, evrows, tspace, task.max_seq_length)
    mc = task.model_config(vocab.vocab_size, tspace.num_targets)
    tower = mc.src_tower
    plan = rnn.layer_plan(tower.cell, tower.embed_dim, tower.hidden)
    tc = task.train_config()
    evaluator = Evaluator(mc, evpairs, tspace)
    state = init_train_state(mc, tc)
    records = []
    with OnTheKernels():
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state = train(mc, tc, pairs, tspace, eval_fn=evaluator.evaluate, log_fn=records.append,
                      state=state)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        missing = [n for n in need if counts.get(n, 0) < 1]
        check(not missing, f"{label}: never launched {missing}: {counts}")
        check(len(records) == 2 and all(math.isfinite(r["loss"]) for r in records)
              and (epochs < 10 or records[-1]["loss"] < records[0]["loss"]),
              f"{label}: loss {records}")
        line = (f"{label} ({tower.cell} x{tower.num_layers}, E={tower.embed_dim}, "
                f"H={tower.hidden}: {plan}): {state.step} steps through train() in {secs:.2f} s "
                f"(evals included), window loss {records[0]['loss']:.4f} -> "
                f"{records[-1]['loss']:.4f}, recall@1 {records[-1]['recall@1']:.4f}; launches "
                f"{ {k: v for k, v in counts.items() if v} }")
        if serve:
            params = inference_params(state)
            index = build_index(params, mc, tspace, batch_size=256, dtype=torch.bfloat16)
            engine = QueryEngine(params, mc, vocab, index, max_seq_length=task.max_seq_length,
                                 max_batch=8, k=K)
            text = evrows[0][0]
            engine.query([text])
            replays = engine.graph_counts()["graph_replays"]
            hits = engine.query([text])
            check(engine.graph_counts()["graph_replays"] > replays and len(hits[0]) == K,
                  f"{label} query: {hits}, graphs {engine.graph_counts()}")
            n = same_as_reference(engine, params, mc, index, [text], hits)
            line += (f"; served {text!r} replayed ({engine.graph_counts()}): top-{K} == "
                     f"topk_reference ({n} positions differ, each within one key bucket)")
    log(line + f" [{card}]")
    return counts


def wide_chain(card: str) -> dict:
    """The compositional recipe's towers (3-layer residual LSTM, dropout
    0.1) at hidden 256 on the train bench's shape (E=D=128, B=256, 128
    negatives, L=50), CHAIN steps a CUDA graph: the first call (warm-up,
    capture, replay) and two replays, inside OnTheKernels, a finite loss,
    the LSTM's cluster instances launched every step; ms a step chained.
    Returns the launch counts of the two replays."""
    from sse_tpu_torch import bench, ops
    from sse_tpu_torch.models.towers import TowerConfig

    tower = TowerConfig(vocab_size=8000, embed_dim=128, hidden=256, encoding_dim=128,
                        cell="lstm", num_layers=3, residual=True, dropout=0.1)
    s = bench.train_setup(tower=tower, chain=CHAIN)
    pk, args = s.packed_variants, (s.tgt_tokens, s.tgt_lens)
    with OnTheKernels():
        t0 = time.perf_counter()
        state, m = s.chain_fn(s.state, pk[0], *args)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        ops.reset_launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(2):
            state, m = s.chain_fn(state, pk[1 + i], *args)
        end.record()
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(bool(torch.isfinite(m["loss"]).all()), f"compositional H=256: loss {m['loss']}")
    per_step = {"lstm_fwd": 6, "rnn_scan_cluster": 6, "lstm_bwd": 6, "lstm_bwd_cluster": 6}
    check(all(counts[k] == v * 2 * CHAIN for k, v in per_step.items()),
          f"compositional H=256 chained: launches {counts}, want {per_step} a step")
    log(f"compositional recipe at hidden 256 chained ({CHAIN} steps a CUDA graph, B=256, L=50; "
        f"the garbage of earlier runs left to the collector): first call {capture_s:.2f} s (warm-up, capture, replay), {start.elapsed_time(end) / (2 * CHAIN):.3f} "
        f"ms a step over 2 replays, loss {float(m['loss'].mean()):.4f}; launches a step "
        f"{ {k: counts[k] // (2 * CHAIN) for k in per_step} } [{card}]")
    del s
    torch.cuda.empty_cache()
    return counts


def wide_slice(card: str) -> dict:
    """The wide widths end to end: the ranking preset (GRU) at hidden 256
    trained 50 steps and serving a query replayed; the compositional
    recipe at hidden 256 chained; a GRU at embed_dim 256, hidden 128 (the
    split forward) and the ranking preset at hidden 100 (padded to 112),
    10 steps each. Returns each run's launch counts."""
    t0 = time.perf_counter()
    runs = {
        "wide ranking": wide_train(card, "ranking preset at hidden 256", "ranking",
                                   ("gru_fwd_split", "rnn_scan_cluster", "gru_bwd",
                                    "gru_bwd_cluster"), 10, serve=True, hidden=256),
        "wide compositional": wide_chain(card),
        "wide embed": wide_train(card, "ranking preset at embed_dim 256", "ranking",
                                 ("gru_fwd_split", "rnn_scan", "gru_bwd"), 2, embed_dim=256),
        "odd hidden": wide_train(card, "ranking preset at hidden 100", "ranking",
                                 ("gru_fwd", "gru_bwd"), 2, hidden=100),
    }
    log(f"wide phase: {time.perf_counter() - t0:.1f} s")
    return runs


def embed_grad_tokens(kind: str, rows: int, gen) -> torch.Tensor:
    """[rows, 50] int64 ids on the card: "passages" (lengths of the qna
    corpus, lognormal median 90, sigma 0.5, cut to 5-50) or "questions"
    (5-30) of uniform ids in [2, 8000) with pad id 0 after each length;
    "uniform" every token a uniform id in [0, 8000)."""
    length = 50
    if kind == "uniform":
        return torch.randint(0, 8000, (rows, length), generator=gen, device="cuda")
    if kind == "passages":
        normal = torch.randn((rows,), generator=gen, device="cuda")
        lens = torch.exp(math.log(90) + 0.5 * normal).clamp(5, length).long()
    else:
        lens = torch.randint(5, 31, (rows,), generator=gen, device="cuda")
    toks = torch.randint(2, 8000, (rows, length), generator=gen, device="cuda")
    return torch.where(torch.arange(length, device="cuda") < lens[:, None], toks, 0)


def embed_grad_slice(card: str) -> dict:
    """Phase 14: the table gradient at the qna step's and the ranking
    preset's shapes, checked, then timed by device ms a call beside
    index_put_ and the byte bound."""
    import ctypes

    from sse_tpu_torch.configs import preset
    from sse_tpu_torch.ops import _build, embed

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    task = preset("ranking")
    cands = task.batch_size * (1 + task.num_hard_negatives) + task.num_negatives
    shapes = {  # name → (tokens, E)
        "qna targets": (embed_grad_tokens("passages", cands, gen), 128),
        "qna questions": (embed_grad_tokens("questions", task.batch_size, gen), 128),
        "ranking uniform": (embed_grad_tokens("uniform", cands, gen), task.embed_dim),
    }
    vocab, out = 8000, {}
    for name, (tokens, E) in shapes.items():
        dy = torch.randn((*tokens.shape, E), generator=gen, device="cuda")
        tok, dy2 = tokens.reshape(-1), dy.reshape(-1, E)
        N = tok.numel()
        got = embed.table_grad(tokens, dy, vocab)
        want = embed.table_grad_reference(tokens.cpu(), dy.cpu(), vocab)
        torch.cuda.synchronize()
        check(torch.equal(got.cpu(), want), f"embed_grad {name}: the kernel differs from its mirror")
        lib = torch.zeros((vocab, E), device="cuda").index_put_((tok,), dy2, accumulate=True)
        err = float((got - lib).abs().max())
        scale = float(torch.zeros((vocab, E), device="cuda").index_put_(
            (tok,), dy2.abs(), accumulate=True).max())
        check(err <= 2.0**-24 * N * scale, f"embed_grad {name}: {err} from index_put_")
        ids, order = torch.sort(tok.to(torch.int32), stable=True)
        dt = torch.empty((vocab, E), device="cuda")
        part = torch.empty((-(-N // embed.CHUNK), 2, E), device="cuda")

        def kernels():
            _build.launch("sse_embed_grad", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3,
                          dy.device, ids.data_ptr(), order.data_ptr(), dy2.data_ptr(),
                          dt.data_ptr(), part.data_ptr(), N, E, vocab)

        calls = {"kernels": kernels, "with_sort": lambda: embed.table_grad(tokens, dy, vocab),
                 "index_put": lambda: torch.zeros((vocab, E), device="cuda").index_put_(
                     (tok,), dy2, accumulate=True)}
        device = call_device_ms(calls)
        events = {k: cuda_ms(fn, reps=20) for k, fn in calls.items()}
        lim = bound(nbytes(dy) + vocab * E * 4, 0.0)
        pads = int((tok == 0).sum())
        longest = int(torch.unique_consecutive(ids, return_counts=True)[1].max())
        out[name] = {"tokens": N, "E": E, "pad_tokens": pads, "longest_run": longest,
                     "max_abs_err_vs_index_put": err,
                     "device_ms": device, "events_ms": events, **lim,
                     "roofline_pct": {k: (100 * lim["bound_ms"] / v if v == v else None)
                                      for k, v in device.items()}}
        log(f"embed_grad {name}: N={N} E={E} pads {pads} longest run {longest}; device ms "
            f"kernels {device['kernels']:.4f}, with sort {device['with_sort']:.4f}, "
            f"index_put_ {device['index_put']:.4f}; events ms {events}; bound "
            f"{lim['bound_ms']:.4f} [{card}]")
    log(f"embed_grad phase: {time.perf_counter() - t0:.1f} s")
    return out


KERNELS = {  # name → (source, the TPU kernel it replaces)
    "gru_fwd": ("sse_tpu_torch/csrc/gru_fwd.cu", "sse_tpu/ops/pallas_rnn.py:337"),
    "gru_bwd": ("sse_tpu_torch/csrc/gru_bwd.cu", "sse_tpu/ops/pallas_rnn.py:384"),
    "lstm_fwd": ("sse_tpu_torch/csrc/rnn_scan.cu", "sse_tpu/ops/pallas_rnn.py:337"),
    "lstm_bwd": ("sse_tpu_torch/csrc/lstm_bwd.cu", "sse_tpu/ops/pallas_rnn.py:384"),
    "rnn_scan": ("sse_tpu_torch/csrc/rnn_scan.cu", "sse_tpu/ops/pallas_rnn.py:102"),
    "topk_stream": ("sse_tpu_torch/csrc/topk_stream.cu", "sse_tpu/ops/fused_topk.py:1056"),
    "topk_exact": ("sse_tpu_torch/csrc/topk_stream.cu",
                   'sse_tpu/ops/fused_topk.py:1056 (variant="exact")'),
    "twophase_p1": ("sse_tpu_torch/csrc/topk_twophase.cu", "sse_tpu/ops/fused_topk.py:762"),
    "twophase_p2": ("sse_tpu_torch/csrc/topk_twophase.cu", "sse_tpu/ops/fused_topk.py:850"),
    **WIDE_KERNELS,
}


def qna_config():
    """The ``qna`` configuration at the served width: a dual-encoder
    1-layer LSTM with the attention readout, E=H=D=128, vocab 8000."""
    from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
    from sse_tpu_torch.models.towers import TowerConfig

    tower = TowerConfig(cell="lstm", readout="attention", vocab_size=8000, embed_dim=128,
                        hidden=128, num_layers=1, encoding_dim=128)
    return SSEConfig(mode=NetworkMode.DUAL_ENCODER, src_tower=tower, tgt_tower=tower)


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        sys.exit(2)
    if "--flags-probe" in sys.argv[1:]:  # flags_check's fresh process: PyTorch's defaults
        flags_probe()
        return
    set_flags()
    if "--sharded-rank" in sys.argv[1:]:  # one rank of sharded_processes
        at = sys.argv.index("--sharded-rank")
        sharded_rank(int(sys.argv[at + 1]), sys.argv[at + 2])
        return
    if "--process-rank" in sys.argv[1:]:  # one rank of process_group
        at = sys.argv.index("--process-rank")
        process_rank(int(sys.argv[at + 1]), int(sys.argv[at + 2]), sys.argv[at + 3])
        return

    from sse_tpu_torch import bench
    from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
    from sse_tpu_torch.models.towers import TowerConfig
    from sse_tpu_torch.ops import _build

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    _build.library()
    log(f"kernel build: {_build.build_info['seconds']:.1f} s")
    for pattern in ("gru_", "rnn_scan", "lstm_bwd", "product_kernel"):
        for line in ptxas_report(_build.build_info["log"], pattern):
            log(f"ptxas: {line}")
    check_products_ptxas(_build.build_info["log"])
    if "--costs" in sys.argv[1:]:
        gru_fwd_costs(card)
        rnn_bwd_costs(card, "gru")
        lstm_fwd_costs(card)
        rnn_bwd_costs(card, "lstm", Bs=(8, 128, 256, 2304))
        qna_query_costs(card)
        wide_costs(card)
        return
    if "--wide" in sys.argv[1:]:
        results = {name: {} for name in WIDE_KERNELS}
        check_wide(card, results)
        wide_slice(card)
        print(json.dumps({"wide": no_nan(results)}, allow_nan=False))
        return
    if "--twophase" in sys.argv[1:]:
        twophase_costs(card)
        return
    if "--stream" in sys.argv[1:]:
        stream_costs(card)
        return
    if "--bench" in sys.argv[1:]:
        bench_sweep(card)
        return
    if "--sharded" in sys.argv[1:]:
        sharded_slice(card)
        return
    if "--grid" in sys.argv[1:]:
        train_grid_slice(card)
        return
    if "--processes" in sys.argv[1:]:
        if torch.cuda.device_count() < 2:  # NCCL takes a card a rank: the gloo runs alone
            process_chains(card)
            cfg = bench._default_model()
            from sse_tpu_torch.models import sse

            sharded_processes(cfg, sse.init_params(cfg, torch.Generator().manual_seed(SEED),
                                                   "cuda"))
            mp_train(card)
            return
        counts = process_chains(card)
        missing = [n for n in PROCESS_KERNELS if counts.get(n, 0) < 1]
        check(not missing, f"kernels never launched on the process chains' path: {missing}")
        return
    if "--chain" in sys.argv[1:]:
        counts = chain_slice(card)
        missing = [n for n in RNN_KERNELS if counts.get(n, 0) < 1]
        check(not missing, f"kernels never launched on the chain phase's path: {missing}")
        return
    if "--graphs" in sys.argv[1:]:
        counts, readings = graphs_slice(card)
        missing = [n for n in GRAPH_KERNELS if counts.get(n, 0) < 1]
        check(not missing, f"kernels never launched on the graphs phase's path: {missing}")
        print(json.dumps({"graphs": no_nan(readings)}, allow_nan=False))
        return
    if "--evals" in sys.argv[1:]:
        counts, readings = evals_slice(card)
        missing = [n for n in EVAL_KERNELS if counts.get(n, 0) < 1]
        check(not missing, f"kernels never launched on the evals phase's path: {missing}")
        print(json.dumps({"evals": no_nan(readings)}, allow_nan=False))
        return
    if "--embed-grad" in sys.argv[1:]:
        print(json.dumps({"embed_grad": no_nan(embed_grad_slice(card))}, allow_nan=False))
        return
    if "--encode" in sys.argv[1:]:
        _, counts, readings = encode_slice(card)
        missing = [n for n in ENCODE_KERNELS if counts.get(n, 0) < 1]
        check(not missing, f"kernels never launched on the encode slice's POSTs: {missing}")
        print(json.dumps({"encode": no_nan(readings)}, allow_nan=False))
        return
    results = {name: {} for name in KERNELS}
    check_gru(card, results)
    check_lstm(card, results)
    check_scan(card, results)
    check_bwd(card, results, "gru")
    rnn_bwd_costs(card, "gru")
    check_bwd(card, results, "lstm")
    rnn_bwd_costs(card, "lstm", Bs=(8, 128, 256, 2304))
    check_wide(card, results)
    check_topk(card, results)
    check_topk_exact(card, results)
    check_transformer(card)
    transformer_costs(card)
    embed_grad_readings = embed_grad_slice(card)

    corpus, encode_counts, encode_readings = encode_slice(card)
    width = dict(vocab_size=8000, embed_dim=128, hidden=128, num_layers=1, encoding_dim=128)
    gru = SSEConfig(mode=NetworkMode.SHARED_ENCODER, src_tower=TowerConfig(cell="gru", **width))
    qna = qna_config()
    graph_counts, graph_readings = graphs_slice(card, corpus)
    eval_counts, eval_readings = evals_slice(card)
    runs = {
        "encode": encode_counts,
        "served GRU": served_slice("served GRU", gru, corpus, (1024,)),
        "served qna": served_slice("served qna", qna, corpus, (4096,)),
        "served exact": served_slice("served exact", gru, corpus, (4096,), variant="exact"),
        "served transformer": served_slice("served transformer", transformer_config(), corpus,
                                           (1024, 4096)),
        "graphs": graph_counts,
        "evals": eval_counts,
        "sharded": sharded_slice(card),
        **bench_slice(card),  # checks each run's kernels itself; "GRU train bench" too
        "compositional train bench": train_bench_slice(
            card, "compositional train bench",
            bench.train_setup(tower=TowerConfig(
                vocab_size=8000, embed_dim=128, hidden=128, encoding_dim=128, cell="lstm",
                num_layers=3, residual=True, dropout=0.1)),
            {"lstm_fwd": 6, "lstm_bwd": 6}),
        "transformer train bench": train_bench_slice(
            card, "transformer train bench",
            bench.train_setup(tower=transformer_config().src_tower),
            dict.fromkeys(RNN_KERNELS, 0)),
        "chain": chain_slice(card),
        "ranking preset": preset_slice(card, "ranking", "gru"),
        "qna preset": preset_slice(card, "qna", "lstm"),
        "transformer preset": preset_slice(card, "ranking", "transformer", recipe="transformer"),
        "cli": cli_slice(card),
        "train grid": train_grid_slice(card),
        "process chains": process_chains(card),
        **wide_slice(card),
    }
    need = {
        "encode": ENCODE_KERNELS,
        "served GRU": ("gru_fwd", "topk_stream", "twophase_p1", "twophase_p2"),
        "served qna": ("lstm_fwd", "rnn_scan", "topk_stream", "twophase_p1", "twophase_p2"),
        "GRU train bench": ("gru_fwd", "gru_bwd"),
        "compositional train bench": ("lstm_fwd", "lstm_bwd", "rnn_scan"),
        "ranking preset": ("gru_fwd", "gru_bwd"),
        "qna preset": ("lstm_fwd", "lstm_bwd", "rnn_scan"),
        "served exact": ("gru_fwd", "topk_exact"),
        "served transformer": ("topk_stream", "twophase_p1", "twophase_p2"),
        "sharded": ("gru_fwd", "topk_stream", "twophase_p1", "twophase_p2"),
        "cli": ("gru_fwd", "gru_bwd", "topk_stream"),
        "train grid": ("gru_fwd", "gru_bwd"),
        "chain": RNN_KERNELS,
        "graphs": GRAPH_KERNELS,
        "evals": EVAL_KERNELS,
        "wide ranking": ("gru_fwd_split", "rnn_scan_cluster", "gru_bwd_cluster"),
        "wide compositional": ("lstm_fwd", "rnn_scan_cluster", "lstm_bwd_cluster"),
        "wide embed": ("gru_fwd_split", "gru_bwd"),
        "odd hidden": ("gru_fwd", "gru_bwd"),
    }
    if runs["process chains"]:  # NCCL's runs need two cards
        need["process chains"] = PROCESS_KERNELS
    for run, names in need.items():
        missing = [n for n in names if runs[run].get(n, 0) < 1]
        check(not missing, f"kernels never launched on the {run} path: {missing}")
    for run in ("served transformer", "transformer train bench", "transformer preset"):
        check(all(runs[run][n] == 0 for n in RNN_KERNELS),
              f"a recurrent kernel launched on the {run} path: {runs[run]}")
    launches = {n: sum(c.get(n, 0) for c in runs.values()) for n in KERNELS}
    for name in ("topk_stream", "topk_exact"):
        for b, at in results[name]["at_batch"].items():
            at["launches"] = BATCH_LAUNCHES[name, int(b)]
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name]}
        for name, (src, rep) in KERNELS.items()
    ]
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        check(all(key in k for key in keys), f"kernel line misses a key: {k}")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the device check")
    print(json.dumps({"embed_grad": no_nan(embed_grad_readings)}, allow_nan=False))
    print(json.dumps({"encode": no_nan(encode_readings)}, allow_nan=False))
    print(json.dumps({"graphs": no_nan(graph_readings)}, allow_nan=False))
    print(json.dumps({"evals": no_nan(eval_readings)}, allow_nan=False))
    print(json.dumps({"kernels": no_nan(kernels)}, allow_nan=False))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
