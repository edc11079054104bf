"""CLI: demo-data | train | index | eval | visualize | serve | bench (port
of ``sse_tpu/cli.py``: the same subcommands, flags, defaults, output
lines and exit codes).

Usage:
    python -m sse_tpu_torch.cli demo-data --task classification --out_dir data/
    python -m sse_tpu_torch.cli train --task_type classification \\
        --data_dir data/ --model_dir runs/clf
    python -m sse_tpu_torch.cli index --model_dir runs/clf --data_dir data/
    python -m sse_tpu_torch.cli eval  --model_dir runs/clf --data_dir data/
    python -m sse_tpu_torch.cli serve --model_dir runs/clf --port 8080
    python -m sse_tpu_torch.cli bench --kind query --model_dir runs/clf

Every command runs on the CUDA card and raises where there is none;
``SSE_PLATFORM=cpu`` runs it on the CPU (the counterpart of the JAX CLI's
``SSE_PLATFORM``, which picks JAX's backend). On a machine with several
cards, ``index``, ``eval --use_index`` and ``serve`` run on the
('data', 'model') grid of the config's ``mesh_data`` x ``mesh_model``
(``Workspace.mesh``). Several processes join by ``--coordinator``,
``--num_processes`` and ``--process_id`` (``train``'s flags, as in the
JAX CLI) or ``SSE_COORDINATOR``, ``SSE_NUM_PROCESSES`` and
``SSE_PROCESS_ID`` (any command), before the first touch of a card.
``train`` in several processes trains one model on the grid of every
rank's device (each rank its slice of the global batch; on the CPU too,
with ``SSE_PLATFORM=cpu``); rank 0 writes the metrics and checkpoints.
``index --cp_shards N`` (N > 1) encodes a transformer tower's targets
context-parallel over N devices beside this process's. ``bench`` runs the
port's benchmark (``sse_tpu_torch.bench``) and prints its result as one
JSON line; unlike the JAX CLI it honours ``--seconds``. Its train bench
chains 8 steps a dispatch, as the JAX CLI's does (on the card one CUDA
graph replay), and reports the one-step rate beside it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

_TASKS = ["classification", "ranking", "crosslingual", "qna"]
_INDEX_DTYPES = ["float32", "bfloat16", "int8"]  # torch dtype names


def _parse_bool(s: str) -> bool:
    if s.lower() in ("1", "true", "yes", "on"):
        return True
    if s.lower() in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")


def _add_task_overrides(p: argparse.ArgumentParser) -> None:
    """Every TaskConfig field as a --flag (the reference's tf.app.flags
    surface)."""
    from sse_tpu_torch.configs import TaskConfig

    for f in dataclasses.fields(TaskConfig):
        if f.name == "task_type":
            continue
        # a bare type=bool would make --flag False truthy
        typ = _parse_bool if isinstance(f.default, bool) else type(f.default)
        p.add_argument(f"--{f.name}", type=typ, default=None)


def _overrides(args) -> dict:
    from sse_tpu_torch.configs import TaskConfig

    return {
        f.name: getattr(args, f.name)
        for f in dataclasses.fields(TaskConfig)
        if f.name != "task_type" and getattr(args, f.name, None) is not None
    }


def cmd_demo_data(args) -> int:
    from sse_tpu_torch.data import synthetic

    def val(name, easy_default, hard_default):
        v = getattr(args, name, None)
        return v if v is not None else (easy_default if args.profile == "easy" else hard_default)

    if args.profile == "scale":
        n = val("num_targets", 64, 10_000_000) or 10_000_000
        synthetic.write_scale_corpus(
            args.out_dir, num_targets=n, train_rows=args.train_per_target or 16_384,
            eval_rows=args.eval_per_target or 4_096, seed=args.seed,
        )
        print(f"[sse] wrote scale corpus ({n} targets) to {args.out_dir}")
        return 0
    if args.profile == "compositional":
        train, ev, targets = synthetic.make_compositional_corpus(
            task=args.task, num_targets=val("num_targets", 64, 2048),
            cluster_size=args.cluster_size or 8,
            train_per_target=val("train_per_target", 24, 32),
            eval_per_target=val("eval_per_target", 4, 2), seed=args.seed,
        )
    elif args.profile == "hard":
        train, ev, targets = synthetic.make_hard_corpus(
            task=args.task, num_targets=val("num_targets", 64, 2048),
            cluster_size=args.cluster_size or 16,
            train_per_target=val("train_per_target", 24, 8),
            eval_per_target=val("eval_per_target", 4, 2),
            train_multi_label_frac=args.train_multi_label_frac, seed=args.seed,
        )
    else:
        train, ev, targets = synthetic.make_corpus(
            task=args.task, num_targets=val("num_targets", 64, 2048),
            train_per_target=val("train_per_target", 24, 8),
            eval_per_target=val("eval_per_target", 4, 2), seed=args.seed,
        )
    synthetic.write_corpus(args.out_dir, train, ev, targets)
    print(
        f"[sse] wrote {len(train)} TrainPairs, {len(ev)} EvalPairs, "
        f"{len(targets)} targetIDs to {args.out_dir}"
    )
    return 0


def cmd_train(args) -> int:
    from sse_tpu_torch.configs import preset
    from sse_tpu_torch.utils.device import env_device
    from sse_tpu_torch.workspace import Workspace

    from sse_tpu_torch.parallel import distributed

    multi = distributed.world_size() > 1
    if multi and distributed.rank() != 0:
        distributed.barrier()  # rank 0 has written config.json
        ws = Workspace.open(args.model_dir, env_device())
    else:
        try:
            if args.task_type is not None:
                cfg = preset(args.task_type, recipe=args.recipe, **_overrides(args))
                ws = Workspace.create(args.model_dir, cfg, env_device())
            elif os.path.exists(os.path.join(args.model_dir, "config.json")):
                ws = Workspace.open(args.model_dir, env_device())  # resume with the saved config
                # flags passed on resume still apply (the common case: a larger
                # --max_epochs) and persist back into config.json
                overrides = _overrides(args)
                if overrides:
                    ws = Workspace.create(args.model_dir, dataclasses.replace(ws.cfg, **overrides),
                                          ws.device)
            else:
                print("error: new model_dir needs --task_type", file=sys.stderr)
                return 2
        finally:
            if multi:
                distributed.barrier()
    if args.profile_dir:
        from sse_tpu_torch.utils import trace

        with trace(args.profile_dir):
            final = ws.train(args.data_dir)
    else:
        final = ws.train(args.data_dir)
    print("[sse] final eval: " + json.dumps(final))
    return 0


def cmd_index(args) -> int:
    from sse_tpu_torch.utils.device import env_device
    from sse_tpu_torch.workspace import Workspace

    ws = Workspace.open(args.model_dir, env_device())
    if args.index_dtype:
        # this build only: the saved config is not rewritten, the index
        # carries its dtype in its own sidecar
        ws.cfg = dataclasses.replace(ws.cfg, index_dtype=args.index_dtype)
    t0 = time.perf_counter()
    phases: dict = {}
    index = ws.build_index(
        args.data_dir, export_tsv=args.export_tsv, capacity=args.capacity, phase_times=phases,
        cp_shards=args.cp_shards,
    )
    dt = time.perf_counter() - t0
    breakdown = " ".join(f"{k}={v:.1f}s" for k, v in phases.items())
    print(
        f"[sse] built index: {index.num_real} targets, dim {index.dim}, "
        f"{index.num_real / dt:.1f} docs/sec → {ws.index_dir}\n"
        f"[sse] index phases: {breakdown} "
        f"(encode-only rate {index.num_real / max(phases.get('encode', dt), 1e-9):.1f} docs/sec)"
    )
    return 0


def cmd_eval(args) -> int:
    from sse_tpu_torch.utils.device import env_device
    from sse_tpu_torch.workspace import Workspace

    ws = Workspace.open(args.model_dir, env_device())
    if args.use_index:
        # score through the serving path (the saved index + the top-k
        # kernels), the right mode at large target-space scale
        from sse_tpu_torch.evals import evaluate_against_index
        from sse_tpu_torch.index import ShardedIndex
        from sse_tpu_torch.train import inference_params

        vocab, tspace, _, eval_pairs = ws.prepare_data(args.data_dir)
        model_cfg = ws.model_config(vocab, tspace)
        state, mgr = ws.restore_state(model_cfg)
        mgr.close()
        index = ShardedIndex.load(ws.index_dir, ws.mesh() or ws.device)
        result = evaluate_against_index(inference_params(state), model_cfg, eval_pairs, index)
    else:
        result = ws.evaluate(args.data_dir)
    print("[sse] " + json.dumps(result))
    return 0


def cmd_visualize(args) -> int:
    """Target embeddings in TensorBoard-projector TSV format (the
    reference's visualize mode)."""
    from sse_tpu_torch.index import ShardedIndex
    from sse_tpu_torch.utils.device import env_device
    from sse_tpu_torch.workspace import Workspace

    ws = Workspace.open(args.model_dir, env_device())
    if os.path.isdir(ws.index_dir):
        index = ShardedIndex.load(ws.index_dir, ws.device)
    elif args.data_dir:
        index = ws.build_index(args.data_dir)
    else:
        print("error: no built index; pass --data_dir", file=sys.stderr)
        return 2
    os.makedirs(args.out_dir, exist_ok=True)
    emb = index.emb[: index.num_real].float().cpu().numpy()
    with open(os.path.join(args.out_dir, "tensors.tsv"), "w") as f:
        for row in emb:
            f.write("\t".join(f"{v:.6f}" for v in row) + "\n")
    with open(os.path.join(args.out_dir, "metadata.tsv"), "w", encoding="utf-8") as f:
        f.write("targetId\ttargetText\n")
        for tid, text in zip(index.ids, index.texts):
            f.write(f"{tid}\t{text}\n")
    print(
        f"[sse] wrote {emb.shape[0]}x{emb.shape[1]} embeddings to "
        f"{args.out_dir}/tensors.tsv (+ metadata.tsv) — load in the "
        "TensorBoard Embedding Projector"
    )
    return 0


def cmd_serve(args) -> int:
    from sse_tpu_torch.serve import serve_http
    from sse_tpu_torch.utils.device import env_device
    from sse_tpu_torch.workspace import Workspace

    ws = Workspace.open(args.model_dir, env_device())
    engine = ws.engine(
        data_dir=args.data_dir, k=args.k, max_batch=args.max_batch,
        bulk_batch=args.bulk_batch or None,
    )
    print("[sse] warming serving programs ...", flush=True)
    dt = engine.warmup()
    print(
        f"[sse] serving {engine.index.num_real} targets "
        f"on http://{args.host}:{args.port}  (warmup {dt:.1f}s; Ctrl-C to stop)",
        flush=True,
    )
    serve_http(engine, host=args.host, port=args.port, index_dir=ws.index_dir,
               model_dir=ws.model_dir)
    return 0


def cmd_bench(args) -> int:
    import torch

    from sse_tpu_torch import bench as bench_lib
    from sse_tpu_torch.utils.device import env_device

    device = env_device()
    if args.kind == "query":
        result = bench_lib.run_query_bench(
            model_dir=args.model_dir, num_targets=args.num_targets,
            encoding_dim=args.encoding_dim, batch=args.batch or 64, k=args.k,
            seconds=args.seconds, index_dtype=getattr(torch, args.index_dtype), device=device,
        )
    elif args.kind == "index":
        result = bench_lib.run_index_bench(
            num_targets=args.num_targets, encoding_dim=args.encoding_dim,
            batch_size=args.batch or 512, seconds=args.seconds, device=device,
        )
    else:
        result = bench_lib.run_train_bench(
            num_targets=args.num_targets, encoding_dim=args.encoding_dim,
            batch=args.batch or 256, seconds=args.seconds, device=device,
        )
    print(json.dumps(result))
    return 0


def _add_dist_flags(p) -> None:
    """The JAX CLI's multi-host flags (``train``'s). Environment
    fallbacks, for any command: SSE_COORDINATOR, SSE_NUM_PROCESSES,
    SSE_PROCESS_ID."""
    p.add_argument("--coordinator", default=None, help="coordinator address host:port (process 0's)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)


def _maybe_init_distributed(args) -> None:
    """Join the process group (``parallel.distributed.initialize``) when
    more than one process is asked for."""
    coord = getattr(args, "coordinator", None) or os.environ.get("SSE_COORDINATOR")
    nproc = getattr(args, "num_processes", None)
    if nproc is None and os.environ.get("SSE_NUM_PROCESSES"):
        nproc = int(os.environ["SSE_NUM_PROCESSES"])
    pid = getattr(args, "process_id", None)
    if pid is None and os.environ.get("SSE_PROCESS_ID"):
        pid = int(os.environ["SSE_PROCESS_ID"])
    if (nproc and nproc > 1) or coord:
        from sse_tpu_torch.parallel import distributed

        distributed.initialize(coord, nproc, pid)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="sse_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("demo-data", help="generate synthetic demo corpora")
    p.add_argument("--task", default="classification", choices=_TASKS)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--num_targets", type=int, default=None)
    p.add_argument("--train_per_target", type=int, default=None)
    p.add_argument("--eval_per_target", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--profile", default="easy", choices=["easy", "hard", "compositional", "scale"],
        help="easy: demo corpora; hard: confusable clusters, Zipf words, "
        "multi-label eval rows; compositional: order-sensitive (siblings "
        "share word bags); scale: 10M+ targets streamed to disk "
        "(--train_per_target/--eval_per_target become absolute row counts)",
    )
    p.add_argument("--cluster_size", type=int, default=None,
                   help="targets per confusable cluster (default: 16 hard, 8 compositional)")
    p.add_argument("--train_multi_label_frac", type=float, default=0.0,
                   help="hard profile: fraction of TRAIN rows that are multi-label")
    p.set_defaults(fn=cmd_demo_data)

    p = sub.add_parser("train", help="train a model (reference: sse_main train)")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--model_dir", required=True)
    p.add_argument("--task_type", default=None, choices=_TASKS)
    p.add_argument(
        "--recipe", default=None, choices=["compositional", "transformer"],
        help="named config bundle applied on top of the task preset "
        "(configs.RECIPES; explicit flags still win)",
    )
    _add_task_overrides(p)
    _add_dist_flags(p)
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler Chrome trace of the run into this directory")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("index", help="build the target index (reference: sse_index)")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--export_tsv", default=None, help="also write reference-format TSV")
    p.add_argument("--capacity", type=int, default=None,
                   help="reserve index rows for live POST /api/add growth")
    p.add_argument("--index_dtype", default=None, choices=_INDEX_DTYPES,
                   help="override the trained config's index precision for THIS build")
    p.add_argument("--cp_shards", type=int, default=0,
                   help="context-parallel target encoding over this many devices (transformer, mean readout)")
    p.set_defaults(fn=cmd_index)

    p = sub.add_parser("eval", help="top-N recall eval (reference: sse_evaluator)")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--use_index", action="store_true",
                   help="score via the built index + the serving kernels")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("visualize", help="export embeddings for the TensorBoard projector")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--data_dir", default=None)
    p.add_argument("--out_dir", required=True)
    p.set_defaults(fn=cmd_visualize)

    p = sub.add_parser("serve", help="HTTP query serving (reference: webserver)")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--data_dir", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--max_batch", type=int, default=8,
                   help="low-latency device batch tier (the micro-batcher coalesces up to it)")
    p.add_argument("--bulk_batch", type=int, default=256,
                   help="second batch tier for bulk POST traffic (0 disables)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("bench", help="throughput microbenchmarks")
    p.add_argument("--kind", default="query", choices=["query", "index", "train"])
    p.add_argument("--model_dir", default=None)
    p.add_argument("--num_targets", type=int, default=100_000)
    p.add_argument("--encoding_dim", type=int, default=128)
    p.add_argument("--batch", type=int, default=None)  # per-kind default
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--seconds", type=float, default=5.0, help="timed seconds (at least one window)")
    p.add_argument("--index_dtype", default="float32", choices=_INDEX_DTYPES,
                   help="query bench: index storage precision (serving flagship uses bfloat16)")
    p.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    _maybe_init_distributed(args)  # before the first touch of a card
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
