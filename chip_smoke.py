"""Smoke run of the PyTorch port's serving path on one CUDA GPU.

    python3 chip_smoke.py            # needs one CUDA card; no network

1. Device check: a CUDA card is required (no CPU branch); prints the
   card's name and power limit (nvidia-smi) and the kernel build time.
2. Each Hopper kernel against its plain PyTorch version at the serving
   shapes (index 1,249,280 x 128, k=10): the GRU layer (T=50, B=8 and
   4096, ragged lengths; fin to atol 2e-3 / rtol 1e-3, bf16 ys to one
   bf16 ulp), the streaming top-k (B=8, the served interactive batch, and
   B=256) and the two-phase top-k phases (B=4096), in bf16 and int8, on
   exact-dot inputs so that rows and values must match bit for bit.
3. The served slice at the bench width (shared-encoder 1-layer GRU,
   E=H=D=128, vocab 8000, L=50, random weights from a seed): build_index
   of 1,248,280 synthetic documents on the GPU in bf16, QueryEngine and
   warmup, the HTTP server on a free localhost port, GET and bulk POST
   queries, the rows served to both held against topk_reference, and
   every kernel's launch count from that run.

Any failure raises (non-zero exit). The line before the last is a JSON
object with each kernel's launches, error and times; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
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
        "topk_stream": ("sse_tpu_torch/csrc/topk_stream.cu", "sse_tpu/ops/fused_topk.py:1056"),
        "twophase_p1": ("sse_tpu_torch/csrc/topk_twophase.cu", "sse_tpu/ops/fused_topk.py:762"),
        "twophase_p2": ("sse_tpu_torch/csrc/topk_twophase.cu", "sse_tpu/ops/fused_topk.py:850"),
    }
    results = {name: {} for name in sources}
    check_gru(card, results)
    check_topk(card, results)
    counts = served_slice()
    missing = [name for name in sources if counts.get(name, 0) < 1]
    check(not missing, f"kernels never launched on the served path: {missing}")
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], **results[name]}
        for name, (src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
