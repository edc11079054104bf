"""Benchmark harness: query-path QPS, train steps/sec and index-build
docs/sec on one CUDA card (port of ``sse_tpu/bench.py``).

Same metric names, output keys (plus ``device``, the name of what ran
it), work models and input protocol as the JAX bench: every dispatch
takes the next of 16 distinct inputs, windows of 32 asynchronous
dispatches end in a drain, and each bench reports the best window (the
headline ``value``) beside the whole-stream mean (the train bench's
too, where the JAX bench's one-step branch repeats its best window).
The drain is ``torch.cuda.synchronize``; a window's wall time holds the
host path too, which is what a caller of the port gets. All data is made
on the device from seeded ``torch.Generator``s: nothing is uploaded from
the host.

Every bench runs on the card unless the caller passes ``device="cpu"``,
and raises where there is no card. The roofline fields (``mfu_pct``,
``hbm_pct_of_spec``) come from ``_CHIP_SPECS``, the card's public dense
bf16 peak and HBM rate; an unknown card and the CPU get none.

    python -m sse_tpu_torch.bench       # the headline: one JSON line
    SSE_PLATFORM=cpu python -m sse_tpu_torch.bench   # on the CPU, small index

The train bench times ``chain`` steps a dispatch (8, as the JAX bench):
on the card one replay of a captured CUDA graph (``train.loop``'s
``make_train_step(chain=)``), whose rate per step is the headline, and
the one-step dispatch beside it. The query bench times the captured
query function (``serve/engine.py`` ``CapturedQuery``; on a grid
``GridQuery``, one graph a card replayed before the merge), and the
index bench the encode as one captured graph, with its eager rate
beside it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from sse_tpu_torch.index.sharded_index import _padded_rows, quantize_rows
from sse_tpu_torch.models import sse
from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
from sse_tpu_torch.models.towers import TowerConfig
from sse_tpu_torch.utils.device import env_device
from sse_tpu_torch.utils import graphs
from sse_tpu_torch.utils.graphs import Program
from sse_tpu_torch.utils.profiling import wait_for

# the headline index: the north star's 10M items over 8 chips, per chip
# (2048 x 610 = 4096 x 305 rows, so both top-k routes take it)
HEADLINE_ROWS = 1_249_280
BASELINE_QPS = 10_000.0  # vs_baseline = QPS / this (the north-star per-chip bar)
NUM_VARIANTS = 16  # distinct inputs each bench rotates through
WINDOW = 32  # asynchronous dispatches between two drains


def _bench_tower(encoding_dim: int = 128) -> TowerConfig:
    """The bench tower: 1-layer GRU, E=H=128, vocab 8000."""
    return TowerConfig(vocab_size=8000, embed_dim=128, hidden=128, num_layers=1,
                       encoding_dim=encoding_dim, cell="gru")


def _default_model(encoding_dim: int = 128) -> SSEConfig:
    """The query and index benches' model: the bench tower, shared encoder."""
    return SSEConfig(mode=NetworkMode.SHARED_ENCODER, src_tower=_bench_tower(encoding_dim))


def _bench_device(device: torch.device | str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the bench measures the card (pass device='cpu' to run it on the CPU)"
        )
    return device


def _device_index(
    num_targets: int,
    dim: int,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
    shards: int = 1,
) -> torch.Tensor:
    """Random L2-normalized rows made on ``device`` (no host upload), stored
    as the index stores them (``quantize_rows``), padded to the index's row
    geometry (of ``shards`` row blocks) with zero rows past ``num_targets``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    emb = torch.zeros((_padded_rows(num_targets, None, shards), dim), dtype=dtype, device=device)
    chunk = 1 << 20  # rows drawn at a time: bounds the float32 peak
    for lo in range(0, num_targets, chunk):
        hi = min(lo + chunk, num_targets)
        rows = torch.randn((hi - lo, dim), generator=gen, device=device)
        emb[lo:hi] = quantize_rows(rows / torch.linalg.norm(rows, dim=1, keepdim=True), dtype)
    return emb


def _random_tokens(gen: torch.Generator, shape, vocab_size: int, device) -> torch.Tensor:
    """Token ids in [2, vocab) (0 and 1 are the pad and unknown ids)."""
    return torch.randint(2, vocab_size, shape, generator=gen, device=device, dtype=torch.int32)


def _throughput_time(
    call: Callable[[Any], Any], variants: Sequence[Any], seconds: float = 8.0
) -> Tuple[float, float]:
    """Per-call seconds of ``call(variant)`` under steady pipelined load.

    Every dispatch takes the next of ``variants``, so no two consecutive
    calls share an input; windows of WINDOW asynchronous dispatches end
    in a drain (``wait_for`` of the last output: ``torch.cuda.synchronize``
    on the card), so the device queue stays bounded and a window's time
    covers all of its executions. The first call (which builds the kernels
    and warms the allocator) is not timed; at least one window runs.

    Returns ``(best, mean)`` per-call seconds: the fastest window, and the
    whole-stream average."""
    wait_for(call(variants[0]))
    n = len(variants)
    vi = 1
    best = math.inf
    dispatches = 0
    t0 = time.perf_counter()
    while True:
        w0 = time.perf_counter()
        for _ in range(WINDOW):
            out = call(variants[vi % n])
            vi += 1
        wait_for(out)
        now = time.perf_counter()
        best = min(best, (now - w0) / WINDOW)
        dispatches += WINDOW
        if now - t0 >= seconds:
            return best, (now - t0) / dispatches


# Public dense bf16 peak TFLOP/s and HBM GB/s of each card, keyed by a
# prefix of torch.cuda.get_device_name(); the longest matching prefix wins.
_CHIP_SPECS = (
    ("NVIDIA H100 80GB HBM3", (989.0, 3350.0)),  # SXM
    ("NVIDIA H100 PCIe", (756.0, 2000.0)),
    ("NVIDIA H100 NVL", (835.0, 3900.0)),
)


def _device_kind(device: torch.device) -> str:
    """The device's name as results report it: the card's name, or "cpu"."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _chip_spec(kind: Optional[str]) -> Optional[Tuple[float, float]]:
    """(peak bf16 TFLOP/s, HBM GB/s) of the card named ``kind``, or None."""
    match = None
    for prefix, spec in _CHIP_SPECS:
        if kind and kind.startswith(prefix) and (match is None or len(prefix) > len(match[0])):
            match = (prefix, spec)
    return None if match is None else match[1]


def _roofline_fields(
    per_iter: float, flops: float, hbm_bytes: float, kind: Optional[str] = None
) -> Dict[str, Any]:
    """Achieved GFLOP/s + GB/s and %-of-spec for a measured per-call time.

    ``flops``/``hbm_bytes`` are the MINIMUM algorithmic work and traffic
    (the JAX bench's models), so utilization is honest-or-pessimistic."""
    out: Dict[str, Any] = {
        "achieved_gflops": round(flops / per_iter / 1e9, 1),
        "achieved_hbm_gbps": round(hbm_bytes / per_iter / 1e9, 1),
    }
    spec = _chip_spec(kind)
    if spec is not None:
        peak_tflops, hbm_gbps = spec
        out["mfu_pct"] = round(100.0 * flops / per_iter / (peak_tflops * 1e12), 2)
        out["hbm_pct_of_spec"] = round(100.0 * hbm_bytes / per_iter / (hbm_gbps * 1e9), 1)
    return out


def _tower_flops(rows: int, length: int, tower: TowerConfig, encoding_dim: int) -> int:
    """Minimum encode work of ``rows`` texts of ``length`` tokens: a 3-gate
    cell's input and hidden products a step and layer, and the projection
    (the JAX bench's count, also for 4-gate LSTM towers)."""
    return (
        rows * length * 2 * tower.num_layers
        * (tower.embed_dim * 3 * tower.hidden + tower.hidden * 3 * tower.hidden)
        + rows * 2 * tower.hidden * encoding_dim
    )


# ----------------------------------------------------------------- query
@dataclasses.dataclass
class QuerySetup:
    """What the query bench times: ``call(tokens)`` = the fused query path
    (encode → scores → exact top-k) over ``emb``, on each of ``variants``
    in turn (the first dispatch is ``variants[0]``)."""

    fused: Callable
    params: Any
    model_cfg: SSEConfig
    emb: Any  # torch.Tensor, or the RowShards of a grid
    num_real: int
    k: int
    max_seq_length: int
    lengths: torch.Tensor
    variants: list

    def call(self, tokens: torch.Tensor):
        return self.fused(self.params, self.emb, tokens, self.lengths)


def query_setup(
    model_dir: Optional[str] = None,
    num_targets: int = 100_000,
    encoding_dim: int = 128,
    batch: int = 64,
    k: int = 10,
    max_seq_length: int = 50,
    index_dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
    mesh=None,
) -> QuerySetup:
    """The query bench's inputs. With ``model_dir``: that model dir's
    engine (its index, params, ``max_seq_length`` and ``k``, which the
    engine clamps to the index's real rows; on the workspace's grid where
    it has one). Otherwise the bench tower with random weights (seed 0)
    over ``_device_index``, row-sharded over ``mesh`` when given (then
    ``device`` is the grid's first device, ``batch`` must divide over
    its 'data' axis, and the timed function replays one CUDA graph a
    card of the grid)."""
    if mesh is not None:
        device = mesh.local_devices[0]
    device = _bench_device(device)
    if model_dir:
        from sse_tpu_torch.workspace import Workspace

        engine = Workspace.open(model_dir, device).engine(k=k, max_batch=batch)
        model_cfg, params, fused = engine.model_cfg, engine.params, engine._fused
        emb, num_real, k = engine.index.emb, engine.index.num_real, engine.k
        max_seq_length = engine.max_seq_length
    else:
        from sse_tpu_torch.parallel.mesh import RowShards, replicate
        from sse_tpu_torch.serve.engine import build_fused_query_fn

        model_cfg = _default_model(encoding_dim=encoding_dim)
        params = sse.init_params(model_cfg, torch.Generator().manual_seed(0), device)
        shards = 1 if mesh is None else mesh.shape["model"]
        emb, num_real = _device_index(num_targets, encoding_dim, index_dtype, device,
                                      shards), num_targets
        if mesh is not None:
            emb, params = RowShards.from_tensor(emb, mesh), replicate(params, mesh)
        fused = build_fused_query_fn(model_cfg, k=k, num_real=num_targets, mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(100)
    variants = [
        _random_tokens(gen, (batch, max_seq_length), model_cfg.src_tower.vocab_size, device)
        for _ in range(NUM_VARIANTS)
    ]
    lengths = torch.full((batch,), max_seq_length, dtype=torch.int32, device=device)
    return QuerySetup(fused, params, model_cfg, emb, num_real, k, max_seq_length, lengths,
                      variants)


def first_batch(s: QuerySetup) -> Tuple[torch.Tensor, torch.Tensor, int, list]:
    """The setup's first dispatch, ``s.call(s.variants[0])``, held against
    topk_reference on the same query encodings and index
    (``ops.topk.rows_off_reference``): (values, rows, the count of
    positions that differ, those beyond the kernels' tolerance)."""
    from sse_tpu_torch.ops.topk import rows_off_reference

    from sse_tpu_torch.parallel.mesh import Replicated

    vals, rows = s.call(s.variants[0])
    params = s.params[s.emb.device] if isinstance(s.params, Replicated) else s.params
    with torch.no_grad():
        q = sse.encode_source(params, s.model_cfg, s.variants[0], s.lengths)
    # s.emb[:]: the whole index as one tensor (a grid's row blocks gathered)
    return (vals, rows, *rows_off_reference(q, s.emb[:], rows, s.num_real))


def run_query_bench(
    model_dir: Optional[str] = None,
    num_targets: int = 100_000,
    encoding_dim: int = 128,
    batch: int = 64,
    k: int = 10,
    seconds: float = 8.0,
    max_seq_length: int = 50,
    index_dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
    mesh=None,
) -> Dict[str, Any]:
    """End-to-end fused query path (token ids → encode → scores → exact
    top-k) queries/sec, the best of windows over ``seconds`` (over the
    row-sharded index of ``mesh`` when given, see ``query_setup``)."""
    return time_query(query_setup(model_dir, num_targets, encoding_dim, batch, k,
                                  max_seq_length, index_dtype, device, mesh), seconds)


def time_query(s: QuerySetup, seconds: float = 8.0) -> Dict[str, Any]:
    """``run_query_bench``'s timing and result of an existing setup (so a
    caller can check the very object that was timed)."""
    batch = len(s.lengths)
    per_iter, per_iter_mean = _throughput_time(s.call, s.variants, seconds)
    d = s.model_cfg.encoding_dim
    # minimum algorithmic work: the scoring product over the real rows and
    # the recurrent encode; traffic: one read of the real rows
    flops = 2 * batch * s.num_real * d + _tower_flops(
        batch, s.max_seq_length, s.model_cfg.src_tower, d)
    hbm_bytes = s.num_real * d * s.emb.element_size()
    out = {
        "metric": "queries_per_sec_exact_topk",
        "value": round(batch / per_iter, 1),
        "unit": f"qps, best sustained window (batch={batch}, k={s.k}, "
        f"T={s.num_real}, D={d}, L={s.max_seq_length})",
        "num_targets": s.num_real,
        "batch": batch,
        "k": s.k,
        "ms_per_batch": round(per_iter * 1000, 3),
        "qps_stream_mean": round(batch / per_iter_mean, 1),
        "ms_per_batch_stream_mean": round(per_iter_mean * 1000, 3),
        "device": _device_kind(s.emb.device),
    }
    out.update(_roofline_fields(per_iter, flops, hbm_bytes, out["device"]))
    return out


# ----------------------------------------------------------------- train
@dataclasses.dataclass
class TrainSetup:
    """What the train bench times: ``call((src, labels))`` = one train step
    of ``state`` on a variant's source tokens and labels against the
    ``tgt_tokens`` target space, and ``call_chain(packed_k)`` = ``chain``
    steps in one dispatch on one of ``packed_variants`` ([chain, B, W]
    packed batches). Each call steps the same state, as the JAX bench's
    undonated step does."""

    step_fn: Callable
    chain_fn: Optional[Callable]  # None at chain=1
    chain: int
    state: Any
    model_cfg: SSEConfig
    num_negatives: int
    max_seq_length: int
    lengths: torch.Tensor
    weight: torch.Tensor
    tgt_tokens: torch.Tensor
    tgt_lens: torch.Tensor
    variants: list
    packed_variants: list

    def call(self, v):
        src, labels = v
        _, metrics = self.step_fn(self.state, src, self.lengths, labels, self.weight,
                                  self.tgt_tokens, self.tgt_lens)
        return metrics["loss"]

    def call_chain(self, packed_k):
        _, metrics = self.chain_fn(self.state, packed_k, self.tgt_tokens, self.tgt_lens)
        return metrics["loss"]


def train_setup(
    batch: int = 256,
    num_targets: int = 10_000,
    max_seq_length: int = 50,
    num_negatives: int = 128,
    encoding_dim: int = 128,
    device: torch.device | str = "cuda",
    tower: Optional[TowerConfig] = None,
    chain: int = 8,
) -> TrainSetup:
    """The train bench's inputs: a dual-encoder of ``tower`` (the bench's
    GRU tower unless given), sampled-softmax negatives, Adam, random
    weights (seed 0) and random tokens made on ``device``; at ``chain > 1``
    the chain step and 4 packed chunks of ``chain`` batches, batch j of
    chunk i the variant (i·chain + j) mod 16, as the JAX bench packs
    them."""
    from sse_tpu_torch.train import LossConfig, TrainConfig, init_train_state, make_train_step

    device = _bench_device(device)
    tower = tower or _bench_tower(encoding_dim)
    model_cfg = SSEConfig(mode=NetworkMode.DUAL_ENCODER, src_tower=tower, tgt_tower=tower)
    cfg = TrainConfig(batch_size=batch, steps_per_dispatch=chain,
                      loss=LossConfig(kind="sampled", num_negatives=num_negatives))
    state = init_train_state(model_cfg, cfg, torch.Generator().manual_seed(0), device)
    vocab = tower.vocab_size
    gen = torch.Generator(device=device).manual_seed(1)
    variants = [
        (
            _random_tokens(gen, (batch, max_seq_length), vocab, device),
            torch.randint(0, num_targets, (batch,), generator=gen, device=device,
                          dtype=torch.int32),
        )
        for _ in range(NUM_VARIANTS)
    ]
    lengths = torch.full((batch,), max_seq_length, dtype=torch.int32, device=device)
    weight = torch.ones((batch,), dtype=torch.float32, device=device)
    packed_variants = []
    if chain > 1:
        wcol = weight.view(torch.int32)[:, None]
        packed = lambda v: torch.cat([v[0], lengths[:, None], v[1][:, None], wcol], 1)  # noqa: E731
        packed_variants = [
            torch.stack([packed(variants[(i * chain + j) % NUM_VARIANTS]) for j in range(chain)])
            for i in range(4)
        ]
    return TrainSetup(
        step_fn=make_train_step(model_cfg, cfg),
        chain_fn=make_train_step(model_cfg, cfg, packed_width=max_seq_length, chain=chain)
        if chain > 1 else None,
        chain=chain,
        state=state,
        model_cfg=model_cfg,
        num_negatives=num_negatives,
        max_seq_length=max_seq_length,
        lengths=lengths,
        weight=weight,
        tgt_tokens=_random_tokens(gen, (num_targets, max_seq_length), vocab, device),
        tgt_lens=torch.full((num_targets,), max_seq_length, dtype=torch.int32, device=device),
        variants=variants,
        packed_variants=packed_variants,
    )


def run_train_bench(
    batch: int = 256,
    num_targets: int = 10_000,
    max_seq_length: int = 50,
    num_negatives: int = 128,
    encoding_dim: int = 128,
    chain: int = 8,
    seconds: float = 5.0,
    device: torch.device | str = "cuda",
) -> Dict[str, Any]:
    """Training throughput: the train step (dual-encoder GRU, sampled-softmax
    negatives, Adam; the hand-written GRU forward and backward kernels on
    the card) steps/sec and examples/sec at ``chain`` steps a dispatch
    (TrainConfig.steps_per_dispatch; on the card one CUDA graph replay),
    with the one-step dispatch's rate beside it."""
    return time_train(train_setup(batch, num_targets, max_seq_length, num_negatives,
                                  encoding_dim, device, chain=chain), seconds)


def time_train(s: TrainSetup, seconds: float = 5.0) -> Dict[str, Any]:
    """``run_train_bench``'s timing and result of an existing setup: the
    one-step dispatch over ``seconds``, then, at ``s.chain > 1``, the
    chained dispatch over ``seconds``, whose per-step time is the
    headline (as the JAX bench reports it)."""
    batch, length, negatives = len(s.lengths), s.max_seq_length, s.num_negatives
    d = s.model_cfg.encoding_dim
    single_iter, single_mean = _throughput_time(s.call, s.variants, seconds)
    if s.chain > 1:
        best, mean = _throughput_time(s.call_chain, s.packed_variants, seconds)
        per_iter, per_iter_mean = best / s.chain, mean / s.chain
    else:
        per_iter, per_iter_mean = single_iter, single_mean
    # FLOP model of the step (fwd + ~2x bwd), minimum algorithmic work:
    # src tower over batch rows + tgt tower over (batch + num_negatives)
    # sampled rows, plus the [B, B+N] loss product
    fwd = (
        _tower_flops(batch, length, s.model_cfg.src_tower, d)
        + _tower_flops(batch + negatives, length, s.model_cfg.tgt_tower, d)
        + 2 * batch * (batch + negatives) * d
    )
    out = {
        "metric": "train_steps_per_sec",
        "value": round(1.0 / per_iter, 2),
        "examples_per_sec": round(batch / per_iter, 1),
        "unit": f"steps/sec, best sustained window (dual-encoder "
        f"{s.model_cfg.src_tower.cell.upper()}, batch={batch}, "
        f"L={length}, {negatives} sampled negatives, {s.chain}-step dispatch chain)",
        "ms_per_step": round(per_iter * 1000, 3),
        "steps_per_sec_stream_mean": round(1.0 / per_iter_mean, 2),
        "steps_per_sec_single_dispatch": round(1.0 / single_iter, 2),
        "device": _device_kind(s.lengths.device),
    }
    roof = _roofline_fields(per_iter, 3 * fwd, hbm_bytes=0, kind=out["device"])
    roof.pop("achieved_hbm_gbps")  # no meaningful traffic floor here
    roof.pop("hbm_pct_of_spec", None)
    out.update(roof)
    return out


# ----------------------------------------------------------------- index
def run_index_bench(
    num_targets: int = 50_000,
    encoding_dim: int = 128,
    batch_size: int = 512,
    max_seq_length: int = 50,
    seconds: float = 8.0,
    device: torch.device | str = "cuda",
) -> Dict[str, Any]:
    """Index-build throughput: target-tower encode docs/sec (the bench
    tower, random weights, one ``batch_size`` batch a dispatch).
    ``num_targets`` is taken for the CLI's flag and, as in the JAX bench,
    not used: the rate is the encode's. As the JAX bench times its jitted
    encode, the headline times the encode as one fixed-shape program
    (``utils.graphs.Program``: a replayed CUDA graph on a card, each
    dispatch the copy of its tokens into the graph's input and a replay);
    ``docs_per_sec_eager`` times the same encode issued op by op, as the
    train bench reports its one-step rate beside the chained one."""
    device = _bench_device(device)
    model_cfg = _default_model(encoding_dim=encoding_dim)
    params = sse.init_params(model_cfg, torch.Generator().manual_seed(0), device)
    gen = torch.Generator(device=device).manual_seed(200)
    lengths = torch.full((batch_size,), max_seq_length, dtype=torch.int32, device=device)
    variants = [
        _random_tokens(gen, (batch_size, max_seq_length), model_cfg.src_tower.vocab_size, device)
        for _ in range(NUM_VARIANTS)
    ]
    tokens_in = torch.empty_like(variants[0])

    def encode(tokens):
        with torch.no_grad():
            return sse.target_embeddings(params, model_cfg, tokens=tokens, lengths=lengths)

    program = Program(lambda: encode(tokens_in), graphs.pool_for(device))

    def replayed(tokens):
        tokens_in.copy_(tokens)
        return program()

    per_iter, per_iter_mean = _throughput_time(replayed, variants, seconds)
    eager_iter, _ = _throughput_time(encode, variants, seconds)
    return {
        "metric": "index_docs_per_sec",
        "value": round(batch_size / per_iter, 1),
        "unit": f"docs/sec, best sustained window (batch={batch_size}, L={max_seq_length})",
        "ms_per_batch": round(per_iter * 1000, 3),
        "docs_per_sec_stream_mean": round(batch_size / per_iter_mean, 1),
        "docs_per_sec_eager": round(batch_size / eager_iter, 1),
        "ms_per_batch_eager": round(eager_iter * 1000, 3),
        "device": _device_kind(device),
    }


# ------------------------------------------------------------- headline
def main() -> int:
    """One JSON line: exact top-10 QPS of the bench tower at B=4096 over a
    bf16 index of HEADLINE_ROWS rows (4096 x 5 rows on the CPU), with
    ``vs_baseline`` = QPS / 10,000 and the roofline fields."""
    device = env_device()
    result = run_query_bench(
        num_targets=HEADLINE_ROWS if device.type == "cuda" else 4096 * 5,
        encoding_dim=128, batch=4096, k=10, index_dtype=torch.bfloat16, device=device,
    )
    out = {
        "metric": result["metric"],
        "value": result["value"],
        "unit": result["unit"],
        "vs_baseline": round(result["value"] / BASELINE_QPS, 4),
    }
    for key in ("qps_stream_mean", "ms_per_batch", "achieved_gflops", "achieved_hbm_gbps",
                "mfu_pct", "hbm_pct_of_spec", "device"):
        if key in result:
            out[key] = result[key]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
