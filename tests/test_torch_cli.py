"""The port's CLI (``python -m sse_tpu_torch.cli``) end to end on the CPU
(``SSE_PLATFORM=cpu``), in process, at the tiny widths of
tests/test_cli.py: the reference's ``make train`` flow and the outputs
and files the JAX CLI test asserts; and a model dir written by
``sse_tpu``'s Workspace served through the port's Workspace.engine.

Tolerance of the cross-package case: the JAX engine on the CPU selects
with ``lax.top_k`` on float32 scores, the port with the packed 11-bit
keys (and an encoder within atol 2e-3 of JAX's), so a differing row is
allowed only where the two rows' scores lie within one key bucket (2^-11
relative) plus 1e-5 of each other.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from sse_tpu import configs as jconfigs
from sse_tpu.workspace import Workspace as JaxWorkspace
from sse_tpu_torch import cli
from sse_tpu_torch.convert import train_state_from_jax
from sse_tpu_torch.train.checkpoint import CheckpointManager
from sse_tpu_torch.workspace import Workspace

TINY = ["--max_epochs", "4", "--batch_size", "16", "--embed_dim", "16", "--hidden", "16",
        "--encoding_dim", "16", "--vocab_size", "200", "--max_seq_length", "12",
        "--steps_per_checkpoint", "8", "--learning_rate", "0.05"]


@pytest.fixture
def run(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SSE_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)

    def go(*args):
        rc = cli.main(list(args))
        out = capsys.readouterr()
        return rc, out.out, out.err

    return go


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1].split("] ", 1)[1])


def test_cli_full_flow(run, tmp_path):
    rc, out, _ = run("demo-data", "--task", "classification", "--out_dir", "data",
                     "--num_targets", "8", "--train_per_target", "8")
    assert rc == 0 and "wrote 64 TrainPairs" in out
    assert (tmp_path / "data" / "TrainPairs").exists()

    rc, out, _ = run("train", "--task_type", "classification", "--data_dir", "data",
                     "--model_dir", "run", *TINY)
    assert rc == 0 and "[sse] final eval: " in out
    final = json.loads(out.split("[sse] final eval: ")[1].splitlines()[0])
    assert 0.0 <= final["recall@1"] <= 1.0
    assert (tmp_path / "run" / "config.json").exists()
    assert (tmp_path / "run" / "metrics.jsonl").exists()
    assert sorted(os.listdir(tmp_path / "run" / "ckpt")) == ["16", "8"]

    # resume with an override: restored, trained on, persisted
    rc, out, _ = run("train", "--data_dir", "data", "--model_dir", "run", "--max_epochs", "6")
    assert rc == 0 and "restored checkpoint step=16" in out and "final eval" in out
    cfg = json.loads((tmp_path / "run" / "config.json").read_text())
    assert cfg["max_epochs"] == 6 and cfg["hidden"] == 16
    assert CheckpointManager(str(tmp_path / "run" / "ckpt")).latest_step() == 24

    rc, out, _ = run("index", "--model_dir", "run", "--data_dir", "data",
                     "--export_tsv", "run/idx.tsv")
    assert rc == 0 and "built index: 8 targets, dim 16" in out
    assert (tmp_path / "run" / "idx.tsv").exists()
    assert (tmp_path / "run" / "index" / "sidecar.json").exists()

    # the query bench over the model dir's engine: its 8-row index, k
    # clamped to the real rows as QueryEngine does
    rc, out, _ = run("bench", "--kind", "query", "--model_dir", "run", "--seconds", "0")
    bench = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and bench["metric"] == "queries_per_sec_exact_topk" and bench["value"] > 0
    assert bench["num_targets"] == 8 and bench["k"] == 8 and bench["batch"] == 64
    assert "T=8, D=16, L=12" in bench["unit"] and bench["device"] == "cpu"

    rc, out, _ = run("eval", "--model_dir", "run", "--data_dir", "data")
    plain = _last_json(out)
    assert rc == 0 and "recall@1" in plain
    rc, out, _ = run("eval", "--model_dir", "run", "--data_dir", "data", "--use_index")
    via_index = _last_json(out)
    assert rc == 0 and "recall@1" in via_index

    rc, out, _ = run("visualize", "--model_dir", "run", "--out_dir", "viz")
    assert rc == 0 and "wrote 8x16 embeddings" in out
    tensors = (tmp_path / "viz" / "tensors.tsv").read_text().splitlines()
    meta = (tmp_path / "viz" / "metadata.tsv").read_text().splitlines()
    assert len(tensors) == 8 and len(meta) == 9 and len(tensors[0].split("\t")) == 16


@pytest.mark.parametrize("flags, cell", [
    (["--recipe", "transformer"], "transformer"),  # 4 pre-LN blocks, RoPE, lr 1e-3
    (["--cell", "bow"], "bow"),
])
def test_cli_other_towers(run, tmp_path, flags, cell):
    """The ``transformer`` recipe and the bag-of-subwords tower through the
    CLI at tiny widths: demo-data, train (ranking preset, dual encoder),
    index, eval --use_index, then a query through the model dir's engine."""
    run("demo-data", "--task", "ranking", "--out_dir", "data", "--num_targets", "8",
        "--train_per_target", "6")
    rc, out, _ = run("train", "--task_type", "ranking", "--data_dir", "data", "--model_dir",
                     "run", *TINY, "--num_negatives", "4", "--num_hard_negatives", "2", *flags)
    assert rc == 0 and "[sse] final eval: " in out
    cfg = json.loads((tmp_path / "run" / "config.json").read_text())
    assert cfg["cell"] == cell and cfg["network_mode"] == "dual-encoder"
    if cell == "transformer":
        assert cfg["num_layers"] == 4 and cfg["pos_encoding"] == "rope"
    rc, out, _ = run("index", "--model_dir", "run", "--data_dir", "data")
    assert rc == 0 and "built index: 8 targets, dim 16" in out
    rc, out, _ = run("eval", "--model_dir", "run", "--data_dir", "data", "--use_index")
    metrics = _last_json(out)
    assert rc == 0 and 0.0 <= metrics["recall@1"] <= 1.0
    engine = Workspace.open(str(tmp_path / "run"), device="cpu").engine(k=3)
    texts = [line.split("\t")[0] for line in
             (tmp_path / "data" / "EvalPairs").read_text().splitlines()[:3]]
    hits = engine.query(texts)
    assert [len(h) for h in hits] == [3, 3, 3]
    assert all(h["targetId"] == engine.index.ids[h["row"]] for row in hits for h in row)


@pytest.mark.parametrize("kind, extra", [
    ("query", ["--num_targets", "512", "--batch", "4", "--encoding_dim", "16"]),
    ("index", ["--num_targets", "256", "--batch", "32", "--encoding_dim", "16"]),
    ("train", ["--num_targets", "256", "--batch", "8", "--encoding_dim", "16"]),
])
def test_cli_bench_kinds(run, kind, extra):
    """Each bench kind runs on the CPU and prints its result as the last
    line (tests/test_cli.py's bench step, with a shortened --seconds)."""
    rc, out, _ = run("bench", "--kind", kind, *extra, "--seconds", "0")
    assert rc == 0
    result = json.loads(out.strip().splitlines()[-1])
    assert result["value"] > 0 and result["device"] == "cpu", (kind, result)


def test_cli_errors_and_flags(run, tmp_path, monkeypatch):
    run("demo-data", "--task", "ranking", "--out_dir", "data", "--num_targets", "8",
        "--train_per_target", "4")
    rc, _, err = run("train", "--data_dir", "data", "--model_dir", "fresh")
    assert rc == 2 and "task_type" in err
    # bool flags parse in both spellings
    rc, _, _ = run("train", "--task_type", "ranking", "--data_dir", "data", "--model_dir",
                   "boolrun", *TINY[:-6], "--max_epochs", "1", "--bidirectional", "False",
                   "--streaming", "true", "--num_hard_negatives", "0")
    assert rc == 0
    cfg = json.loads((tmp_path / "boolrun" / "config.json").read_text())
    assert cfg["bidirectional"] is False and cfg["streaming"] is True
    # --cp_shards reaches the context-parallel encode, which refuses a GRU
    # tower as the JAX package's does (test_cli_two_process_train_and_cp_index
    # indexes a transformer with it)
    with pytest.raises(ValueError, match="sequential"):
        run("index", "--model_dir", "boolrun", "--data_dir", "data", "--cp_shards", "2")
    # --num_processes 2: two ranks resume the model dir and train it on one grid
    ranks = _two_ranks(tmp_path, "train", "--data_dir", "data", "--model_dir", "boolrun",
                       "--max_epochs", "2")
    finals = [out.split("[sse] final eval: ")[1].splitlines()[0] for out in ranks]
    assert finals[0] == finals[1]
    assert "restored checkpoint step=" in ranks[0] and "restored checkpoint step=" in ranks[1]
    monkeypatch.delenv("SSE_PLATFORM")
    if not torch.cuda.is_available():  # without SSE_PLATFORM the CLI wants the card
        with pytest.raises(RuntimeError, match="CUDA"):
            run("eval", "--model_dir", "boolrun", "--data_dir", "data")


def _two_ranks(cwd, *args, limit: int = 180):
    """``python -m sse_tpu_torch.cli *args`` as ranks 0 and 1 of one process
    group over gloo on the CPU (each under its own time limit); returns
    their outputs after checking both exit codes."""
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "SSE_PLATFORM": "cpu", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sse_tpu_torch.cli", *args, "--num_processes", "2",
         "--coordinator", f"127.0.0.1:{port}", "--process_id", str(r)],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=limit)
            assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def test_cli_two_process_train_and_cp_index(run, tmp_path):
    """Two ranks train a transformer (mean readout) through the CLI on one
    grid: the same final eval on both, one metrics.jsonl and one set of
    checkpoints (rank 0's); then ``index --cp_shards 2`` writes the rows
    that ``index`` without it writes."""
    from sse_tpu_torch.index import ShardedIndex

    run("demo-data", "--task", "ranking", "--out_dir", "data", "--num_targets", "8",
        "--train_per_target", "4")
    ranks = _two_ranks(tmp_path, "train", "--task_type", "ranking", "--data_dir", "data",
                       "--model_dir", "tf", *TINY[:-4], "--num_negatives", "4",
                       "--num_hard_negatives", "2", "--recipe", "transformer", "--readout",
                       "mean", "--num_layers", "2", "--max_epochs", "2")
    finals = [out.split("[sse] final eval: ")[1].splitlines()[0] for out in ranks]
    assert finals[0] == finals[1]
    records = (tmp_path / "tf" / "metrics.jsonl").read_text().splitlines()
    assert sum('"final": 1' in line for line in records) == 1  # rank 0 alone writes
    assert CheckpointManager(str(tmp_path / "tf" / "ckpt")).latest_step() == 4
    rc, _, _ = run("index", "--model_dir", "tf", "--data_dir", "data")
    plain = ShardedIndex.load(str(tmp_path / "tf" / "index"), "cpu")
    rc2, out, _ = run("index", "--model_dir", "tf", "--data_dir", "data", "--cp_shards", "2")
    assert rc == rc2 == 0 and "built index: 8 targets" in out
    cp = ShardedIndex.load(str(tmp_path / "tf" / "index"), "cpu")
    np.testing.assert_allclose(cp.emb.numpy(), plain.emb.numpy(), rtol=2e-5, atol=2e-6)


def test_jax_model_dir_serves_in_port(run, tmp_path):
    """config.json, vocab.txt and index/ written by sse_tpu's Workspace;
    the Orbax checkpoint restored by sse_tpu, converted and saved by the
    port's manager. The port's engine serves the JAX engine's rows."""
    run("demo-data", "--task", "ranking", "--out_dir", "data", "--num_targets", "16",
        "--train_per_target", "4")
    cfg = jconfigs.preset("ranking", embed_dim=16, hidden=16, encoding_dim=16, vocab_size=200,
                          max_seq_length=12, batch_size=16, max_epochs=2,
                          steps_per_checkpoint=4, num_negatives=8, num_hard_negatives=0)
    jws = JaxWorkspace.create(str(tmp_path / "jrun"), cfg)
    jws.train("data")
    jws.build_index("data")
    texts = ["alpha", *(line.split("\t")[0] for line in
                        (tmp_path / "data" / "EvalPairs").read_text().splitlines()[:5])]
    jengine = jws.engine(k=5)
    want = jengine.query(texts)

    vocab, tspace, _, _ = jws.prepare_data("data", need_eval=False)
    state, mgr = jws.restore_state(jws.model_config(vocab, tspace), quiet=True)
    mgr.close()
    shutil.copytree(tmp_path / "jrun", tmp_path / "trun", ignore=shutil.ignore_patterns("ckpt"))
    CheckpointManager(str(tmp_path / "trun" / "ckpt")).save(
        train_state_from_jax(jax.tree.map(np.asarray, state)), int(state.step))

    engine = Workspace.open(str(tmp_path / "trun"), device="cpu").engine(k=5)
    got = engine.query(texts)
    assert engine.index.num_real == 16 and [len(h) for h in got] == [5] * len(texts)
    tokens, lengths = engine.encode_queries(texts)
    from sse_tpu_torch.models import sse as tsse

    q = tsse.encode_source(engine.params, engine.model_cfg, tokens, lengths).double()
    emb = engine.index.emb.double()
    for i, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g, w):
            assert a["targetId"] == engine.index.ids[a["row"]]
            if a["row"] != b["row"]:
                sa, sb = float(q[i] @ emb[a["row"]]), float(q[i] @ emb[b["row"]])
                assert abs(sa - sb) <= 2.0**-11 * max(abs(sa), abs(sb)) + 1e-5, (i, a, b)
