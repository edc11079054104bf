"""Smoke run of the PyTorch port on one CUDA GPU: serving and training.

    python3 chip_smoke.py            # needs one CUDA card; no network

1. Device check: a CUDA card is required (no CPU branch); prints the
   card's name and power limit (nvidia-smi) and the kernel build time.
2. Each Hopper kernel against its plain PyTorch version at the shapes of
   the paths below: the GRU layer forward (T=50, B=8 and 4096, ragged
   lengths; fin to atol 2e-3 / rtol 1e-3, bf16 ys to one bf16 ulp), the
   GRU layer backward (T=50, E=H=128, B=128, 256, 384 and 2,304, ragged
   lengths, random dys and dfin; end to end and at each rounding point;
   tolerances in check_gru_bwd), the streaming
   top-k (B=8, the served interactive batch, and B=256) and the
   two-phase top-k phases (B=4096) on the 1,249,280 x 128 index, in bf16
   and int8, on exact-dot inputs so that rows and values must match bit
   for bit.
3. The served slice at the bench width (shared-encoder 1-layer GRU,
   E=H=D=128, vocab 8000, L=50, random weights from a seed): build_index
   of 1,248,280 synthetic documents on the GPU in bf16, QueryEngine and
   warmup, the HTTP server on a free localhost port, GET and bulk POST
   queries, the rows served to both held against topk_reference, and
   every kernel's launch count from that run.
4. The trained slice: (a) the train bench's configuration (dual-encoder
   1-layer GRU, E=H=D=128, vocab 8000, L=50, batch 256, 128 sampled
   negatives over 10,000 random targets, Adam): warm ms/step and the
   step's device time split by the profiler range or op that launched
   each kernel (step_split), two GRU forward and two
   backward launches a step; (b) the ``ranking`` task preset trained by
   ``sse_tpu_torch.train.train`` on the ranking demo corpus with the
   Evaluator as its eval_fn: finite, falling loss, rising recall@1, and
   its EMA params serve one query through QueryEngine whose rows match
   topk_reference.

Any failure raises (non-zero exit). The line before the last is a JSON
object with each kernel's launches, error and times; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import random
import socket
import subprocess
import sys
import time
import urllib.request

import torch

T_PAD = 1_249_280  # the bench index: 305 x 4096 rows
D = 128
K = 10
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


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


# ------------------------------------------------------------ phase 2
def check_gru(card: str, results: dict) -> None:
    from sse_tpu_torch.ops import rnn

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    T, E, H = 50, 128, 128
    wx = torch.randn((E, 3 * H), generator=gen, device="cuda") * 0.08
    wh = torch.randn((H, 3 * H), generator=gen, device="cuda") * 0.08
    b = torch.randn((3 * H,), generator=gen, device="cuda") * 0.05
    err = 0.0
    for B in (8, 4096):
        xs = torch.randn((T, B, E), generator=gen, device="cuda").to(torch.bfloat16)
        lens = torch.randint(1, T + 1, (B,), generator=gen, device="cuda")
        mask = (torch.arange(T, device="cuda")[:, None] < lens[None, :]).float()[:, None, :]
        mask = mask.contiguous()
        args = (xs, mask, wx.bfloat16(), wh.bfloat16(), b)
        ys, fin = rnn.rnn_layer(*args)
        rys, rfin = rnn.rnn_layer_reference(*args)
        torch.cuda.synchronize()
        # fin (float32) within the JAX package's tolerance; ys is bfloat16,
        # so a float32 carry that differs in its last bits by the order of
        # the sums may round to the neighbouring bf16 value: one bf16 ulp
        torch.testing.assert_close(fin, rfin, atol=2e-3, rtol=1e-3)
        torch.testing.assert_close(ys.float(), rys.float(), atol=2e-3, rtol=2.0**-7)
        e = float((fin - rfin).abs().max())
        e_ys = float((ys.float() - rys.float()).abs().max())
        flips = int((ys != rys).sum())
        err = max(err, e, e_ys)
        ms = cuda_ms(lambda: rnn.rnn_layer(*args))
        plain = cuda_ms(lambda: rnn.rnn_layer_reference(*args), reps=3)
        log(f"gru_fwd T={T} B={B} E=H={H}: fin max_abs_err {e:.3g} (atol 2e-3, rtol 1e-3), "
            f"{flips} of {ys.numel()} bf16 ys values differ (max {e_ys:.3g}, one ulp); "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms [{card}]")
        if B == 4096:
            results["gru_fwd"].update(ms=ms, plain_ms=plain)
    results["gru_fwd"]["max_abs_err"] = err


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


def check_gru_bwd(card: str, results: dict) -> None:
    """The GRU backward kernels against the plain version, at the main
    path's shapes (T=50, E=H=128: B=128 and 2,304, the ranking preset's
    source and target towers; B=256 and 384, the train bench's) and two
    short ones (T=1, B=1; T=3, B=33).

    End to end (rnn_layer_bwd against rnn_layer_bwd_reference): dWx, dWh
    and db to at most 1e-3 of each tensor's max-abs; dxs to one bf16 ulp
    plus 1e-4 of its max-abs at every step when T <= 3, at the reverse
    loop's first step (t = T-1) at T=50, and to 1e-2 of its max-abs over
    all T=50 steps. The looser bound at T=50 is the dh chain's: both
    versions round dgates to bf16 at every step from fp32 sums taken in
    another order, a value at a rounding edge goes the other way, and the
    chain carries that difference to every earlier step.

    Rounding points, at T=50 (gru_bwd_launch also returns the kernels'
    gates and dgates_b): the plain version's gate recompute against the
    kernel's gates to 1e-5 of max-abs; the plain chain, fed the kernel's
    gates and driven by its dgates_b (rnn.gru_bwd_chain's ``drive``),
    against the kernel's dgates_b, and bf16(dgates_b·Wxᵀ) of the kernel's
    dgates_b against its dxs, each held_to_one_ulp; xsᵀ·dgates_b,
    h_prevᵀ·dgates_b and the chain's db against the kernel's to 1e-5 of
    max-abs. Without the chain's drift these hold where the end-to-end
    bounds cannot: a version that fed fp32 dgates to the dh, dxs or dW
    product, or summed bf16 dgates into db, misses them about 100-fold,
    while the end-to-end bounds let the dh and db cases through."""
    from sse_tpu_torch.ops import rnn

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    E = H = 128
    worst = {"dxs": 0.0, "dwx": 0.0, "dwh": 0.0, "db": 0.0}
    pinned = {}
    err = 0.0
    for T, B in ((1, 1), (3, 33), (50, 128), (50, 256), (50, 384), (50, 2304)):
        wx = (torch.randn((E, 3 * H), generator=gen, device="cuda") * 0.08).bfloat16()
        wh = (torch.randn((H, 3 * H), generator=gen, device="cuda") * 0.08).bfloat16()
        b = torch.randn((3 * H,), generator=gen, device="cuda") * 0.05
        xs = torch.randn((T, B, E), generator=gen, device="cuda").bfloat16()
        lens = torch.randint(1, T + 1, (B,), generator=gen, device="cuda")
        mask = (torch.arange(T, device="cuda")[:, None] < lens).float()[:, None, :].contiguous()
        ys, _ = rnn.rnn_layer(xs, mask, wx, wh, b)
        dys = (torch.randn((T, B, H), generator=gen, device="cuda") * 0.1).bfloat16()
        dfin = torch.randn((B, H), generator=gen, device="cuda")
        args = (xs, ys, mask, wx, wh, b, dys, dfin)
        out = rnn.gru_bwd_launch(*args)
        torch.cuda.synchronize()
        got, (gates, dgb) = out[:4], out[4:]
        want = rnn.rnn_layer_bwd_reference(*args)
        gx, wx_ = got[0].float(), want[0].float()
        ulp = dict(atol=1e-4 * float(wx_.abs().max()), rtol=2.0**-7)
        if T <= 3:
            torch.testing.assert_close(gx, wx_, **ulp)
        else:
            torch.testing.assert_close(gx[-1], wx_[-1], **ulp)
        line = []
        for name, g, w in zip(("dxs", "dwx", "dwh", "db"), got, want):
            e = float((g.float() - w.float()).abs().max())
            rel = e / max(float(w.float().abs().max()), 1e-30)
            check(rel <= (1e-2 if name == "dxs" else 1e-3),
                  f"gru_bwd T={T} B={B} {name}: max_abs_err {e} is {rel:.3g} of max-abs")
            worst[name] = max(worst[name], rel)
            err = max(err, e)
            line.append(f"{name} {e:.3g} ({rel:.2g} of max-abs)")
        msg = f"gru_bwd T={T} B={B} E=H={H}: " + ", ".join(line)
        if T == 50:
            h_prev = rnn._h_prev(ys)
            dgb_r, db_r = rnn.gru_bwd_chain(gates, h_prev, mask, wh, dys, dfin, drive=dgb)
            dxs_r, dwx_r, dwh_r = rnn.gru_bwd_products(xs, h_prev, wx, dgb)
            rels = {}
            for name, g, w in (("gates", gates, rnn.gru_gates(xs, h_prev, wx, wh, b)),
                               ("dwx", got[1], dwx_r), ("dwh", got[2], dwh_r), ("db", got[3], db_r)):
                rels[name] = float((g - w).abs().max()) / float(w.abs().max())
                check(rels[name] <= 1e-5,
                      f"gru_bwd T={T} B={B} pinned {name}: {rels[name]:.3g} of max-abs (bound 1e-5)")
                pinned[name] = max(pinned.get(name, 0.0), rels[name])
            msg += ("; pinned: " + held_to_one_ulp(f"dgates_b B={B}", dgb_r, dgb) + ", "
                    + held_to_one_ulp(f"dxs B={B}", got[0], dxs_r) + ", "
                    + ", ".join(f"{k} {v:.2g} of max-abs" for k, v in rels.items()))
            ms = cuda_ms(lambda: rnn.rnn_layer_bwd(*args))
            plain = cuda_ms(lambda: rnn.rnn_layer_bwd_reference(*args), reps=2)
            msg += f"; kernel {ms:.4f} ms, plain {plain:.4f} ms"
            if B == 384:
                results["gru_bwd"].update(ms=ms, plain_ms=plain, cuda_kernels=bwd_split(args))
        log(msg + f" [{card}]")
    results["gru_bwd"].update(max_abs_err=err, rel_err=worst, pinned_rel_err=pinned)
    log(f"gru_bwd kernels at T=50, B=384 (torch.profiler, ms per backward): "
        f"{json.dumps(results['gru_bwd']['cuda_kernels'])}")


BWD_KERNELS = {  # CUDA kernel of csrc/gru_bwd.cu → what it computes
    "gemm_kernel<false, false, 0>": "gates",
    "gru_bwd_dh_kernel": "dh_loop",
    "gemm_kernel<false, false, 1>": "dxs",
    "gemm_kernel<true, true, 2>": "dw",
    "gru_bwd_reduce_kernel": "reduce",
}


def device_times(prof) -> dict:
    """Name → total device ms of each event on the device timeline of a
    torch.profiler run (kernels, copies, and the spans of profiler ranges;
    CPU ops, which also report the device time of what they launched,
    are left out so nothing counts twice)."""
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        if t > 0:
            out[ev.key] = out.get(ev.key, 0.0) + t / 1000.0
    return out


def bwd_split(args, reps: int = 5) -> dict:
    """Device ms of each CUDA kernel of one backward, from torch.profiler."""
    from sse_tpu_torch.ops import rnn

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            rnn.rnn_layer_bwd(*args)
        torch.cuda.synchronize()
    split = {}
    for key, ms in device_times(prof).items():
        for pat, name in BWD_KERNELS.items():
            if pat in key:
                split[name] = split.get(name, 0.0) + ms / reps
    check(set(split) == set(BWD_KERNELS.values()), f"gru_bwd kernels seen: {split}")
    return split


def check_topk(card: str, results: dict) -> None:
    from sse_tpu_torch.index.sharded_index import quantize_rows
    from sse_tpu_torch.ops import topk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    nr = T_PAD - 1000
    bt = topk.twophase_block_t(T_PAD, K)
    nblocks = T_PAD // bt
    for dtype in ("bf16", "int8"):
        if dtype == "bf16":
            emb = exact_dot((T_PAD, D), gen)
            q_all = exact_dot((4096, D), gen)
        else:
            emb = quantize_rows(unit_rows(T_PAD, gen), torch.int8)
            q_all = topk.quantize_queries_int8(unit_rows(4096, gen))

        # streaming at B = 8 (the served interactive batch: 16-query tiles,
        # hundreds of 64-row tiles per split) and at B = 256 (64-query tiles)
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
            if dtype == "bf16" and B == 8:
                r.update(ms=ms, plain_ms=plain)
        q = q_all[:8].contiguous()
        for small_nr in (0, 5):  # fully padded, and fewer real rows than k
            v, rows = topk.fused_score_topk(q, emb, K, small_nr)
            same(f"topk_stream {dtype} num_real={small_nr}", (v, rows),
                 topk.topk_reference(q, emb, K, small_nr))
            check(torch.isfinite(v).all() and (v[:, small_nr:] < -1e37).all(),
                  f"topk_stream {dtype} num_real={small_nr}: sinks must be finite")
            check(((rows >= 0) & (rows < T_PAD)).all(), "sink rows must be in range")
        log(f"topk_stream {dtype}: num_real=0 and num_real<k give finite sinks, in-range rows")

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
        if dtype == "bf16":
            results["twophase_p1"].update(ms=ms1, plain_ms=plain1)
            results["twophase_p2"].update(ms=ms2, plain_ms=plain2)
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


def served_slice() -> dict:
    """Build, serve and query the bench-width model; returns the kernels'
    launch counts from this run (reset just before it)."""
    from sse_tpu.data import synthetic
    from sse_tpu.data.corpus import build_vocab, encode_target_space
    from sse_tpu_torch import ops
    from sse_tpu_torch.index import build_index
    from sse_tpu_torch.models import sse
    from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
    from sse_tpu_torch.models.towers import TowerConfig
    from sse_tpu_torch.serve import QueryEngine, serve_http

    t0 = time.perf_counter()
    train, evalp, targets = synthetic.make_corpus(task="ranking", num_targets=1024, seed=SEED)
    vocab = build_vocab(8000, train, targets)
    words = sorted({w for _, t in targets for w in t.split()})
    rnd = random.Random(SEED)
    docs = list(targets) + [
        (f"x{i:07d}", " ".join(rnd.choices(words, k=rnd.randint(3, 8))))
        for i in range(T_PAD - 1000 - len(targets))
    ]
    tspace = encode_target_space(vocab, docs, 50)
    log(f"corpus: {len(docs)} documents, vocab {vocab.vocab_size}, "
        f"token width {tspace.tokens.shape[1]} ({time.perf_counter() - t0:.1f} s host)")
    cfg = SSEConfig(
        mode=NetworkMode.SHARED_ENCODER,
        src_tower=TowerConfig(vocab_size=8000, embed_dim=128, hidden=128, num_layers=1,
                              encoding_dim=128, cell="gru"),
    )
    params = sse.init_params(cfg, torch.Generator().manual_seed(SEED), device="cuda")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    index = build_index(params, cfg, tspace, batch_size=4096, dtype=torch.bfloat16,
                        capacity=T_PAD)
    torch.cuda.synchronize()
    check(index.padded_size == T_PAD and index.num_real == len(docs), "index geometry")
    log(f"build_index: {index.num_real} rows in a {index.padded_size}-row bf16 index, "
        f"{time.perf_counter() - t0:.2f} s")
    engine = QueryEngine(params, cfg, vocab, index, max_seq_length=50, max_batch=8, k=K,
                         bulk_batch=4096)
    log(f"warmup: {engine.warmup():.2f} s")
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
        texts = [s for s, _ in evalp[:1024]]
        t0 = time.perf_counter()
        served = http_json(base + "/api/query", {"queries": texts})["results"]
        log(f"POST /api/query with {len(texts)} texts: {time.perf_counter() - t0:.3f} s")
        stats = http_json(base + "/api/stats")
    finally:
        server.shutdown()
        server.server_close()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"launches during the served run: {counts}; server stats: queries={stats['queries']}")
    check(len(served) == len(texts), "POST: one result list per query")
    for hits in served:
        check(len(hits) == K and all(h["targetId"] in known for h in hits), f"POST: {hits}")

    for name, tx, res in (("GET", get_texts, got), ("POST", texts, served)):
        n = same_as_reference(engine, params, cfg, index, tx, res)
        log(f"served rows == topk_reference for {len(tx)} {name} queries "
            f"({n} positions differ, each within one key bucket)")
    return counts


def same_as_reference(engine, params, cfg, index, texts, served) -> int:
    """Served rows against topk_reference on the same query encodings and
    index. The kernel and the reference sum in different orders, so a
    differing position is allowed only where the two rows' scores lie
    within one key bucket (2^-11 relative). Returns the count of such."""
    from sse_tpu_torch.models import sse
    from sse_tpu_torch.ops import topk

    tokens, lengths = engine.encode_queries(texts)
    with torch.no_grad():
        q = sse.encode_source(params, cfg, tokens, lengths)[: len(texts)]
    _, ref_rows = topk.topk_reference(q, index.emb, K, index.num_real)
    rows = torch.tensor([[h["row"] for h in hits] for hits in served], device="cuda")
    diff = (rows != ref_rows).nonzero().tolist()
    qb = q.to(torch.bfloat16).double()
    for i, j in diff:
        a = float(qb[i] @ index.emb[rows[i, j]].double())
        b = float(qb[i] @ index.emb[ref_rows[i, j]].double())
        check(abs(a - b) <= 2.0**-11 * max(abs(a), abs(b)),
              f"served row {i},{j} differs beyond one key bucket: {a} vs {b}")
    return len(diff)


# ------------------------------------------------------------ phase 4
OWN_OPS = {"RNNLayer": "gru_fwd", "RNNLayerBackward": "gru_bwd"}  # autograd op → part
OUTSIDE = "outside the ranges"


def step_split(prof) -> tuple:
    """Device ms of a profiled run's kernels by the part of the train step
    that launched them; returns (part → ms, {part → {kernel → ms}} for
    the parts a reader should check by name).

    A kernel belongs to the innermost op that launched it (the profiler's
    correlation). Walking up from that op, the first of these decides:
    the port's GRU op (``RNNLayer``, ``RNNLayerBackward``) is its own
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


def train_bench_slice(card: str) -> dict:
    """The train bench's configuration (sse_tpu/bench.py:231-263), random
    tokens: warm ms/step over 24 steps, two GRU forward and two GRU
    backward launches a step, the step's split (step_split). Returns the
    launch counts of the timed steps (reset just before them)."""
    from sse_tpu_torch import ops
    from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
    from sse_tpu_torch.models.towers import TowerConfig
    from sse_tpu_torch.train import LossConfig, TrainConfig, init_train_state, make_train_step

    batch, num_targets, L = 256, 10_000, 50
    tower = TowerConfig(vocab_size=8000, embed_dim=128, hidden=128, num_layers=1,
                        encoding_dim=128, cell="gru")
    mc = SSEConfig(mode=NetworkMode.DUAL_ENCODER, src_tower=tower, tgt_tower=tower)
    cfg = TrainConfig(batch_size=batch, loss=LossConfig(kind="sampled", num_negatives=128))
    state = init_train_state(mc, cfg, torch.Generator().manual_seed(SEED), device="cuda")
    step_fn = make_train_step(mc, cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    tgt_tokens = torch.randint(2, 8000, (num_targets, L), generator=g, device="cuda")
    tgt_lens = torch.full((num_targets,), L, device="cuda")
    lengths = torch.full((batch,), L, device="cuda")
    weight = torch.ones((batch,), device="cuda")
    variants = [
        (torch.randint(2, 8000, (batch, L), generator=g, device="cuda"),
         torch.randint(0, num_targets, (batch,), generator=g, device="cuda"))
        for _ in range(16)
    ]
    losses = []

    def run(n):
        nonlocal state
        for i in range(n):
            src, labels = variants[i % len(variants)]
            state, m = step_fn(state, src, lengths, labels, weight, tgt_tokens, tgt_lens)
            losses.append(m["loss"])

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
    check(counts["gru_fwd"] == 2 * n and counts["gru_bwd"] == 2 * n,
          f"train bench: {n} steps launched {counts}, want 2 gru_fwd and 2 gru_bwd a step")
    check(bool(torch.isfinite(torch.stack(losses)).all()), "train bench: non-finite loss")

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
    per_step = lambda d: json.dumps(  # noqa: E731
        {k[:70]: round(v, 4) for k, v in sorted(d.items(), key=lambda kv: -kv[1])})
    log(f"train bench (dual-encoder GRU E=H=D=128, vocab 8000, L=50, B=256, 128 sampled "
        f"negatives, 10,000 targets, Adam): {ms_step:.4f} ms/step over {n} warm steps "
        f"(CUDA events); launches {counts} [{card}]")
    log(f"train step split (torch.profiler, {prof_steps} steps, ms per step): wall {wall:.4f}, "
        f"device busy {busy:.4f} ({100.0 * busy / wall:.1f}%), host/idle {wall - busy:.4f}; "
        f"by the range or op that launched each kernel (step_split): " + per_step(split))
    for part, kernels in by_name.items():
        top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8])
        log(f"kernels of '{part}' (ms per step): " + per_step({k: v / prof_steps for k, v in top.items()}))
    return counts


def ranking_slice(card: str) -> dict:
    """The ``ranking`` task preset trained through train() on the ranking
    demo corpus, the Evaluator as eval_fn; then its EMA params serve one
    query through QueryEngine. Returns the launch counts of the training
    run (reset just before it)."""
    from sse_tpu.data import synthetic
    from sse_tpu.data.corpus import build_vocab, encode_pairs, encode_target_space
    from sse_tpu_torch import configs, ops
    from sse_tpu_torch.evals import Evaluator
    from sse_tpu_torch.index import build_index
    from sse_tpu_torch.serve import QueryEngine
    from sse_tpu_torch.train import inference_params, init_train_state, train

    # 640 pairs / batch 128 = 5 steps an epoch: 60 epochs = 300 steps
    task = configs.preset("ranking", max_epochs=60, steps_per_checkpoint=50)
    rows, evrows, targets = synthetic.make_corpus(task="ranking", seed=SEED)
    vocab = build_vocab(task.vocab_size, rows, targets,
                        max_subtoken_length=task.max_subtoken_length, vocab_mode=task.vocab_mode)
    tspace = encode_target_space(vocab, targets, task.max_seq_length)
    pairs = encode_pairs(vocab, rows, tspace, task.max_seq_length)
    evpairs = encode_pairs(vocab, evrows, tspace, task.max_seq_length)
    mc = task.model_config(vocab.vocab_size, tspace.num_targets)
    tc = task.train_config()
    evaluator = Evaluator(mc, evpairs, tspace)
    state = init_train_state(mc, tc, device="cuda")
    before = evaluator.evaluate(inference_params(state))
    records = []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state = train(mc, tc, pairs, tspace, eval_fn=evaluator.evaluate, log_fn=records.append,
                  state=state)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(counts["gru_fwd"] > 0 and counts["gru_bwd"] > 0, f"ranking: launches {counts}")
    check(all(math.isfinite(r["loss"]) for r in records), f"ranking: loss {records}")
    first, last = records[0], records[-1]
    check(last["loss"] < first["loss"], f"ranking: loss did not fall: {first} -> {last}")
    check(last["recall@1"] > before["recall@1"],
          f"ranking: recall@1 {before['recall@1']} at step 0 -> {last['recall@1']}")
    log(f"ranking preset: {state.step} steps in {secs:.2f} s (evals included), window loss "
        f"{first['loss']:.4f} (step {first['step']}) -> {last['loss']:.4f} (step {last['step']}), "
        f"recall@1 {before['recall@1']:.4f} (step 0) -> {last['recall@1']:.4f}, recall@10 "
        f"{before['recall@10']:.4f} -> {last['recall@10']:.4f}, lr {last['lr']:.6g}; "
        f"launches {counts} [{card}]")

    params = inference_params(state)
    index = build_index(params, mc, tspace, batch_size=256, dtype=torch.bfloat16)
    engine = QueryEngine(params, mc, vocab, index, max_seq_length=task.max_seq_length,
                         max_batch=8, k=K)
    text = evrows[0][0]
    hits = engine.query([text])
    check(len(hits) == 1 and len(hits[0]) == K, f"ranking query: {hits}")
    n = same_as_reference(engine, params, mc, index, [text], hits)
    log(f"ranking EMA params served {text!r}: top-{K} rows == topk_reference "
        f"({n} positions differ, each within one key bucket); top hit {hits[0][0]['targetId']}")
    return counts


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False

    from sse_tpu_torch.ops import _build

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    _build.library()
    log(f"kernel build: {_build.build_info['seconds']:.1f} s")
    sources = {
        "gru_fwd": ("sse_tpu_torch/csrc/gru_fwd.cu", "sse_tpu/ops/pallas_rnn.py:337"),
        "gru_bwd": ("sse_tpu_torch/csrc/gru_bwd.cu", "sse_tpu/ops/pallas_rnn.py:384"),
        "topk_stream": ("sse_tpu_torch/csrc/topk_stream.cu", "sse_tpu/ops/fused_topk.py:1056"),
        "twophase_p1": ("sse_tpu_torch/csrc/topk_twophase.cu", "sse_tpu/ops/fused_topk.py:762"),
        "twophase_p2": ("sse_tpu_torch/csrc/topk_twophase.cu", "sse_tpu/ops/fused_topk.py:850"),
    }
    results = {name: {} for name in sources}
    check_gru(card, results)
    check_gru_bwd(card, results)
    check_topk(card, results)
    served = served_slice()
    missing = [n for n in ("gru_fwd", "topk_stream", "twophase_p1", "twophase_p2")
               if served.get(n, 0) < 1]
    check(not missing, f"kernels never launched on the served path: {missing}")
    trained = [train_bench_slice(card), ranking_slice(card)]
    for counts in trained:
        missing = [n for n in ("gru_fwd", "gru_bwd") if counts.get(n, 0) < 1]
        check(not missing, f"kernels never launched on the trained path: {missing}")
    launches = {n: sum(c.get(n, 0) for c in [served, *trained]) for n in sources}
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name]}
        for name, (src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
