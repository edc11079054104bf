"""Two processes of the port joined over gloo (``sse_tpu_torch.parallel
.distributed``) on the CPU, each holding two entries of one grid: the
port of ``tests/test_multiprocess.py``. The sharded fused query on a
(1, 4) grid gives both ranks the single-process rows (bit for bit: the
same CPU kernels on the same rows), and an index saved by the two
processes, each writing its own row blocks, loads back equal in one
process. ``train()`` on a (4, 1) grid across the two processes (each
feeding its slice of the global batch) gives both ranks the same params
(rel 1e-6), equal to the single-process run of the same global batches
(rel 2e-4, as the JAX test holds its own), in the ``full`` and
``flagship`` modes, with Adam (the JAX test's optimizer) and with SGD. The context-parallel encode over a {'seq': 4} grid
across the two processes gives the single process's output and
gradients. ``distributed.sum_over_ranks`` (one ``all_reduce``) gives
both ranks the same bits.

The chain across processes: at ``steps_per_dispatch`` 2 full chunks go
through the chain function of a grid across processes (over gloo, its
eager chain), in the ``full`` and ``flagship`` modes with Adam: both
ranks end with the same state bits, the same bits as the two-process run
at ``steps_per_dispatch`` 1 and within rel 2e-4 of the single-process
run; in ``full`` mode, from JAX's init state with SGD, within rel 2e-4
of JAX's one-process ``sse_tpu.train.train`` at the same
``steps_per_dispatch`` (the full softmax draws nothing, so both runs
take the same steps).
Over gloo ``distributed.captures()`` is false and the chain function is
the eager one; both ranks issue the same collectives (op, shape, type),
a chain call of K steps K times one step's; a capture that failed on one
rank, or whose readings differ, raises on every rank
(``utils.graphs.agree``). What NCCL would capture runs here with a
stand-in for the capture (a replay runs the program again on its fixed
buffers) and the collectives over gloo: the chain of a grid across
processes (``loop._GridChain``, its ranks agreeing on the recording)
replays as the eager chain bit for bit, and a grid query whose card body
holds the exchange and the merge gives the eager call's and the single
process's rows. Each process runs under its own time limit."""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "_torch_mp_worker.py")
sys.path.insert(0, os.path.join(_REPO, "tests"))

import _torch_mp_worker as worker  # noqa: E402

LIMIT = 120  # seconds each process may take


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(*args) -> dict:
    """Start both workers, wait for each within LIMIT, return their RESULT
    lines by process id (killing both if either fails)."""
    coord = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen([sys.executable, _WORKER, str(i), "2", coord, *args],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         env=env, cwd=_REPO)
        for i in range(2)
    ]
    results = {}
    try:
        for p in procs:
            out, err = p.communicate(timeout=LIMIT)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            line = [x for x in out.splitlines() if x.startswith("RESULT ")][-1]
            r = json.loads(line[len("RESULT "):])
            results[r["pid"]] = r
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


def test_two_process_serving_matches_single_process():
    from sse_tpu_torch.index.sharded_index import from_embeddings
    from sse_tpu_torch.serve.engine import build_fused_query_fn

    results = _run_pair("serve")
    r0, r1 = results[0], results[1]
    assert r0["backend"] == r1["backend"] == "gloo"  # no card: gloo, by the rule
    assert r0["rows"] == r1["rows"] and r0["vals"] == r1["vals"]
    assert r0["topk_ok"] and r1["topk_ok"]
    emb, ids, texts, cfg, params, tokens, lengths = worker.serve_problem()
    idx = from_embeddings(emb, ids, texts, device="cpu")
    vals, rows = build_fused_query_fn(cfg, k=5, num_real=idx.num_real)(
        params, idx.emb, tokens, lengths)
    assert r0["rows"] == rows.tolist()
    np.testing.assert_array_equal(np.asarray(r0["vals"], np.float32), vals.numpy())


def test_two_process_index_save_then_single_process_load(tmp_path):
    from sse_tpu_torch.index.sharded_index import ShardedIndex

    out_dir = str(tmp_path / "mpidx")
    results = _run_pair("indexsave", out_dir)
    assert results[0]["saved"] and results[1]["saved"]
    with open(os.path.join(out_dir, "sidecar.json")) as f:
        side = json.load(f)
    assert side["format"] == "npy-v1"
    assert [s["row0"] for s in side["shards"]] == [0, 16, 32, 48]  # one a grid column
    idx = ShardedIndex.load(out_dir, "cpu")
    emb, ids, texts = worker.saved_problem()
    assert idx.padded_size == 64 and idx.num_real == 50
    np.testing.assert_array_equal(idx.emb[:50].numpy(), emb)
    assert not idx.emb[50:].any()
    assert idx.ids == ids and idx.texts == texts
    grid = ShardedIndex.load(out_dir, worker.make_mesh(1, 2, devices=[worker.CPU] * 2))
    assert torch.equal(grid.emb[:], idx.emb) and grid.ids == ids


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("mode", ["full", "flagship"])
def test_two_process_train(mode, optimizer):
    """mode='full': source-encoder-only, full softmax. mode='flagship':
    dual-encoder sampled softmax with mined hard negatives (the cache
    refreshed inside the run, so its agreement across ranks is on the
    line) and multi-label rows. ``adam`` is the JAX test's optimizer (the
    TrainConfig defaults), which answers to the last bits of a gradient
    that nearly cancels; ``sgd`` at lr 0.05 holds the gradients' sums."""
    from sse_tpu_torch.train import train

    results = _run_pair(mode, optimizer)
    r0, r1 = results[0], results[1]
    assert r0["step"] == r1["step"] == 8  # 64 pairs / batch 16 x 2 epochs
    assert r0["copies_identical"] and r1["copies_identical"]
    assert r0["table_sum"] == pytest.approx(r1["table_sum"], rel=1e-6)
    assert r0["table_abs"] == pytest.approx(r1["table_abs"], rel=1e-6)
    pairs, tspace, model_cfg, cfg = worker.build_problem(mode, optimizer)
    state = train(model_cfg, cfg, pairs, tspace, device="cpu")
    ref_sum, ref_abs = worker.params_sums(state.params)
    assert r0["table_sum"] == pytest.approx(ref_sum, rel=2e-4)
    assert r0["table_abs"] == pytest.approx(ref_abs, rel=2e-4)


def test_sum_over_ranks_gives_every_rank_the_same_bits():
    """``distributed.sum_over_ranks`` (one ``all_reduce``) over two gloo
    ranks: both ranks get the same float32 bits, within one rounding of
    each addend (rtol 1e-6 of the float64 sum's magnitude) of the exact
    sum, and each rank's own tensor is left as it was."""
    results = _run_pair("sum")
    r0, r1 = results[0], results[1]
    assert r0["bits"] == r1["bits"]
    assert r0["left_as_it_was"] and r1["left_as_it_was"]
    got = np.asarray(r0["bits"], np.int32).view(np.float32).reshape(37, 5)
    a, b = (worker.sum_problem(p).double().numpy() for p in (0, 1))
    assert np.all(np.abs(got - (a + b)) <= 1e-6 * (np.abs(a) + np.abs(b)))


def test_two_process_context_parallel_encode():
    """The {'seq': 4} grid across two processes (gather_rows with the
    summed backward for K and V, the projection's gradient whole on each
    rank): both ranks' outputs equal the single process's 4-shard encode
    (rtol 2e-5 / atol 2e-6) and their gradients are within JAX's CP
    tolerance, 1e-2 of max(1, max |ref|), of it."""
    from sse_tpu_torch.parallel.context import cp_mesh, make_cp_encoder

    results = _run_pair("cp")
    cfg, params, tokens, lengths, v = worker.cp_problem()
    out, grads = worker.cp_grads(make_cp_encoder(cfg, cp_mesh(4, [worker.CPU] * 4)), params,
                                 tokens, lengths, v)
    for r in results.values():
        np.testing.assert_allclose(np.asarray(r["out"], np.float32), out.numpy(), rtol=2e-5,
                                   atol=2e-6)
        for got, want in zip(r["grads"], grads):
            want = want.reshape(-1).numpy()
            tol = 1e-2 * max(1.0, float(np.abs(want).max()))
            assert float(np.abs(np.asarray(got, np.float32) - want).max()) <= tol


# ------------------------------------------------ the chain across processes
CHAIN = 2  # steps a dispatch: 4 steps an epoch hold full chunks


def _plain(tree):
    """A JAX pytree's dicts, lists and tuples with numpy leaves."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plain(v) for v in tree)
    return np.asarray(tree)


@pytest.fixture(scope="module")
def jax_full(tmp_path_factory):
    """(the file of JAX's init state of the ``full`` problem with SGD at lr
    0.05, the params sums of JAX's one-process train() from it at
    steps_per_dispatch CHAIN)."""
    import jax
    import _mp_worker as jax_worker
    from sse_tpu.train import loop as jloop

    pairs, tspace, model_cfg, cfg = jax_worker.build_problem("full")
    cfg = dataclasses.replace(cfg, steps_per_dispatch=CHAIN, learning_rate=0.05, optimizer="sgd")
    js = jloop.init_train_state(jax.random.PRNGKey(cfg.seed), model_cfg, cfg)
    path = str(tmp_path_factory.mktemp("jax_init") / "state.npy")
    worker.save_state(path, _plain(js.params), 0, None, None, int(js.step), float(js.lr))
    final = jloop.train(model_cfg, cfg, pairs, tspace, state=js)
    assert int(final.step) == 8
    return path, jax_worker.params_sums(final.params)


@pytest.fixture(scope="module")
def chain_runs():
    """``runs(mode, k)``: both ranks' results of train() at
    steps_per_dispatch k with Adam, each pair run once."""
    done = {}

    def runs(mode, k):
        if (mode, k) not in done:
            done[mode, k] = _run_pair(mode, "adam", str(k))
        return done[mode, k]

    return runs


@pytest.mark.parametrize("mode", ["full", "flagship"])
def test_two_process_chain_ranks_agree(chain_runs, mode):
    r0, r1 = chain_runs(mode, CHAIN).values()
    assert r0["step"] == r1["step"] == 8
    assert r0["copies_identical"] and r1["copies_identical"]
    assert r0["digest"] == r1["digest"]


@pytest.mark.parametrize("mode", ["full", "flagship"])
def test_two_process_chain_equals_single_steps(chain_runs, mode):
    """The chained run takes the same steps as the unchained one: the same
    state bits."""
    assert chain_runs(mode, CHAIN)[0]["digest"] == chain_runs(mode, 1)[0]["digest"]


@pytest.mark.parametrize("mode", ["full", "flagship"])
def test_two_process_chain_matches_single_process(chain_runs, mode):
    from sse_tpu_torch.train import train

    pairs, tspace, model_cfg, cfg = worker.build_problem(mode, "adam")
    cfg = dataclasses.replace(cfg, steps_per_dispatch=CHAIN)
    state = train(model_cfg, cfg, pairs, tspace, device="cpu")
    ref_sum, ref_abs = worker.params_sums(state.params)
    r0 = chain_runs(mode, CHAIN)[0]
    assert r0["table_sum"] == pytest.approx(ref_sum, rel=2e-4)
    assert r0["table_abs"] == pytest.approx(ref_abs, rel=2e-4)


def test_two_process_chain_matches_jax(jax_full):
    """Both ranks, from JAX's init state, after 8 SGD steps (lr 0.05) at
    steps_per_dispatch CHAIN against JAX's one-process train() from it:
    the same state on both ranks, the params' sum of |.| within rel 2e-4
    and their sum within 2e-4 of that (the signed sum nearly cancels).
    SGD, not Adam: the two packages round a bf16 product's operands apart
    (each leaf 1e-4 to 5e-4 apart in the 2-norm here), and Adam at the
    default lr 0.5 turns the last bits of a gradient that nearly cancels
    into a step of ±lr (the sums 0.4% apart after one step)."""
    path, (ref_sum, ref_abs) = jax_full
    r0, r1 = _run_pair("full", "sgd", str(CHAIN), path).values()
    assert r0["step"] == r1["step"] == 8 and r0["digest"] == r1["digest"]
    assert r0["table_abs"] == pytest.approx(ref_abs, rel=2e-4)
    assert abs(r0["table_sum"] - ref_sum) <= 2e-4 * ref_abs


@pytest.fixture(scope="module")
def rule():
    return _run_pair("rule")


def test_gloo_grid_chain_runs_eagerly(rule):
    """Over gloo nothing is captured across processes: ``captures()`` is
    false and ``make_train_step(mesh=, chain=K)`` gives the eager chain."""
    for r in rule.values():
        assert r["captures"] is False
        assert r["full_chain_eager"] and r["flagship_chain_eager"]


@pytest.mark.parametrize("mode", ["full", "flagship"])
def test_ranks_issue_the_same_collectives(rule, mode):
    logs = [r["logs"][mode] for r in rule.values()]
    assert logs[0] == logs[1]
    one, chain = logs[0]["step"], logs[0]["chain"]
    assert one and chain == one * worker.RULE_K
    assert {op for op, _, _ in one} == {"all_gather", "all_reduce"}


def test_capture_that_fails_on_one_rank_raises_on_every_rank(rule):
    r0, r1 = rule[0]["agree"], rule[1]["agree"]
    assert r0["agreed"] == r1["agreed"] == "returned"
    assert "failed on rank(s) [1]" in r0["one failed"] and r1["one failed"] == "made to fail"
    for r in (r0, r1):
        assert "the ranks captured different programs" in r["readings differ"]


@pytest.fixture(scope="module")
def stand_in():
    return _run_pair("stand_in")


@pytest.mark.parametrize("mode", ["full", "flagship"])
def test_stand_in_chain_across_processes_replays_as_eager(stand_in, mode):
    r0, r1 = (r[mode] for r in stand_in.values())
    for r in (r0, r1):
        assert r["agreed"] and r["replays_equal"]
        assert r["collectives"]["all_gather"] and r["collectives"]["all_reduce"]
    assert r0["digest"] == r1["digest"] and r0["collectives"] == r1["collectives"]


def test_stand_in_grid_query_exchanges_inside_the_body(stand_in):
    from sse_tpu_torch.index.sharded_index import from_embeddings
    from sse_tpu_torch.serve.engine import build_fused_query_fn

    emb, ids, texts, cfg, params, tokens, lengths = worker.serve_problem()
    idx = from_embeddings(emb, ids, texts, device="cpu")
    vals, rows = build_fused_query_fn(cfg, k=5, num_real=idx.num_real)(
        params, idx.emb, tokens, lengths)
    want = [vals.tolist(), rows.tolist()]
    for r in stand_in.values():
        q = r["query"]
        assert q["exchange"] and q["counts"] == {"graph_captures": 1, "graph_replays": 1,
                                                 "graph_eager": 0}
        assert q["first"] == q["replay"] == q["eager"] == want
