"""Two trees of the port, timed in turns on one CUDA card: the wide
recurrent backwards, the cluster dh loop's cost a step, and the
compositional recipe's chained train step at hidden 256.

    python3 tools/wide_bwd_turns.py PARENT CHANGE [MORE ...]   # needs one CUDA card
    python3 tools/wide_bwd_turns.py --steps PARENT CHANGE ...    # the dh steps alone

PARENT, CHANGE (and any more) are checkouts of the repository (``git
archive``). The script runs them in turns, forward then backward (parent,
change, change, parent), each in a process of its own that imports that
tree's ``sse_tpu_torch`` (the measuring code is this file's and this
repository's ``chip_smoke.py`` helpers, the same for every tree). Each
process measures, at T=50, E=128, Glorot weights:

- the layer backward (``rnn.rnn_layer_bwd``, fed the kernels' forward)
  of the GRU and the LSTM at H=256 and 384, ragged lengths, at B=8, at
  the train bench's towers (the LSTM at B=256, the GRU at B=384) and at
  B=4096, and at H=128 (the single-block instances) at the towers'
  batches: held against the plain version (dWx, dWh, db to 1e-3 of
  max-abs, dxs to 1e-2), its time (CUDA events) and its device time by
  kernel (torch.profiler: gates, dh loop, dxs, dW, reduce); for the LSTM
  also cuDNN's ``torch.nn.LSTM`` backward at the same shape (full
  lengths): its CUDA-event time, and the device time of every kernel of
  one call of each, the two run in turns in one profiler session
  (``chip_smoke.call_device_ms``);
- the dh loop alone of either cell at H=256 and 384, full lengths, B=8,
  256, 384 and 4096: µs a step, the slope of its kernel's device time
  over T=1, 2, 50;
- the compositional recipe's towers (3-layer residual LSTM) at hidden 256
  on the train bench's shape, 8 steps a CUDA graph: ms a step over two
  replays (CUDA events).

With the tree's ``rnn.card_dh_tile`` (trees that have it) each reading
carries the dh loop's tile (C, R, clusters, waves). Prints one line a
tree and run, the table of the four runs, and the card's name and power
limit. ``--out FILE`` also writes the runs as JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ROWS = (("gru", 256, 8), ("gru", 256, 384), ("gru", 256, 4096),
        ("lstm", 256, 8), ("lstm", 256, 256), ("lstm", 256, 4096),
        ("gru", 384, 8), ("gru", 384, 384), ("gru", 384, 4096),
        ("lstm", 384, 8), ("lstm", 384, 256), ("lstm", 384, 4096),
        ("gru", 128, 384), ("lstm", 128, 256))
STEP_BATCHES = (8, 256, 384, 4096)


def measure(tree: str, rows: bool = True) -> dict:
    """The readings of one tree, in this process (its sse_tpu_torch first
    on the path); ``rows`` False: the dh steps alone."""
    import importlib.util

    import torch

    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from sse_tpu_torch.ops import _build, rnn

    assert os.path.dirname(os.path.dirname(rnn.__file__)) == os.path.join(tree, "sse_tpu_torch")
    smoke.set_flags()
    _build.library()
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 24)
    T, E = 50, 128

    def tile(cell: str, H: int, B: int):
        if not hasattr(rnn, "card_dh_tile"):
            return None
        G = 4 if cell == "lstm" else 3
        plan = rnn.layer_plan(cell, E, H)
        if plan.dh_cluster == 1:
            return None
        return rnn.card_dh_tile(dev, G, plan.H_p, B, plan.dh_cluster)._asdict()

    out = {"rows": {}, "steps": {}, "chain_ms": None}
    for cell, H, B in ROWS if rows else ():
        G = 4 if cell == "lstm" else 3
        wx, wh, b = smoke.glorot_weights(E, H, G, gen)
        xs = torch.randn((T, B, E), generator=gen, device="cuda").bfloat16()
        mask = smoke.ragged_mask(T, B, gen)
        plan = rnn.layer_plan(cell, E, H)
        if cell == "lstm":
            ys, _, cs, _ = rnn.rnn_fwd_launch(xs, mask, wx, wh, b, "lstm",
                                              cluster=plan.scan_cluster)
        else:
            (ys, _), cs = rnn.rnn_layer(xs, mask, wx, wh, b), None
        dys = (torch.randn((T, B, H), generator=gen, device="cuda") * 0.1).bfloat16()
        dfin = torch.randn((B, H), generator=gen, device="cuda")
        args = (xs, ys, mask, wx, wh, b, dys, dfin)
        run = lambda: rnn.rnn_layer_bwd(*args, cs=cs, cell=cell)  # noqa: E731
        got, want = run(), rnn.rnn_layer_bwd_reference(*args, cs, cell)
        for part, g, w in zip(("dxs", "dwx", "dwh", "db"), got, want):
            rel = float((g.float() - w.float()).abs().max()) / float(w.float().abs().max())
            smoke.check(rel <= (1e-2 if part == "dxs" else 1e-3),
                        f"{cell} backward H={H} B={B} {part}: {rel:.3g} of max-abs")
        split = smoke.bwd_split(run, cell)
        row = dict(ms=smoke.cuda_ms(run), device=sum(split.values()), dh_loop=split["dh_loop"],
                   split=split, tile=tile(cell, H, B))
        if cell == "lstm":
            lstm = smoke.cudnn_lstm(wx, wh, b)
            x_l = xs.clone().requires_grad_(True)
            y_l, _ = lstm(x_l)
            inputs = [x_l, *lstm.parameters()]
            cudnn = lambda: torch.autograd.grad(y_l, inputs, dys, retain_graph=True)  # noqa: E731
            both = smoke.call_device_ms({"ours": run, "cudnn": cudnn})
            row.update(cudnn_ms=smoke.cuda_ms(cudnn), call_device_ms=both["ours"],
                       cudnn_device_ms=both["cudnn"])
        out["rows"][f"{cell} {H} {B}"] = row
        del got, want, args, xs, ys, cs
        torch.cuda.empty_cache()
    for cell, G in (("gru", 3), ("lstm", 4)):
        for H in (256, 384):
            wx, wh, b = smoke.glorot_weights(E, H, G, gen)
            for B in STEP_BATCHES:
                ms = {}
                for t in (1, 2, 50):
                    xs = torch.randn((t, B, E), generator=gen, device="cuda").bfloat16()
                    mask = torch.ones((t, 1, B), device="cuda")
                    ys, _, cs = rnn._scan_reference(rnn._x_product(xs, wx, b), mask, wh, cell)
                    dys = (torch.randn((t, B, H), generator=gen, device="cuda") * 0.1).bfloat16()
                    dfin = torch.randn((B, H), generator=gen, device="cuda")
                    ms[t] = smoke.kernel_ms(
                        lambda: rnn.rnn_layer_bwd(xs, ys, mask, wx, wh, b, dys, dfin, cs, cell),
                        f"{cell}_bwd_dh_")
                ts = sorted(ms)
                mt, mm = sum(ts) / len(ts), sum(ms.values()) / len(ts)
                slope = (sum((t - mt) * (ms[t] - mm) for t in ts)
                         / sum((t - mt) ** 2 for t in ts))
                out["steps"][f"{cell} {H} {B}"] = dict(us=1000.0 * slope, tile=tile(cell, H, B))
    if rows:
        out["chain_ms"] = chain_ms(smoke)
    return out


def chain_ms(smoke) -> float:
    """ms a step of the compositional recipe's towers at hidden 256
    (chip_smoke.wide_chain's setup: 3-layer residual LSTM, B=256, L=50,
    128 negatives), chip_smoke.CHAIN steps a CUDA graph: the first call
    captures, then two replays timed by CUDA events."""
    import torch

    from sse_tpu_torch import bench
    from sse_tpu_torch.models.towers import TowerConfig

    tower = TowerConfig(vocab_size=8000, embed_dim=128, hidden=256, encoding_dim=128,
                        cell="lstm", num_layers=3, residual=True, dropout=0.1)
    s = bench.train_setup(tower=tower, chain=smoke.CHAIN)
    pk, args = s.packed_variants, (s.tgt_tokens, s.tgt_lens)
    state, m = s.chain_fn(s.state, pk[0], *args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(2):
        state, m = s.chain_fn(state, pk[1 + i], *args)
    end.record()
    torch.cuda.synchronize()
    smoke.check(bool(torch.isfinite(m["loss"]).all()), f"compositional: loss {m['loss']}")
    return start.elapsed_time(end) / (2 * smoke.CHAIN)


def main() -> None:
    args = sys.argv[1:]
    if args and args[0] == "--measure":  # one tree, in its own process
        turn = measure(os.path.abspath(args[1]), rows=args[2:] != ["--steps"])
        print("TURN " + json.dumps(turn), flush=True)
        return
    out = None
    if "--out" in args:
        at = args.index("--out")
        out = args[at + 1]
        del args[at:at + 2]
    steps = "--steps" in args
    trees = [os.path.abspath(a) for a in args if a != "--steps"]
    names = ["parent", "change"] + [os.path.basename(t) for t in trees[2:]]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    runs = []
    order = list(zip(names, trees))
    for name, tree in order + order[::-1]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", tree,
                               *(["--steps"] if steps else [])],
                              capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(proc.stdout[-4000:])
            raise SystemExit(f"{name} ({tree}) failed: {proc.returncode}")
        line = [x for x in proc.stdout.splitlines() if x.startswith("TURN ")][-1]
        runs.append((name, json.loads(line[5:])))
        print(f"{name}: {line[5:]}", flush=True)
    print(f"[{card}] layer backward at T=50, E=128: device ms of its kernels (of it the dh "
          "loop), ms (CUDA events), and for the LSTM the device ms of every kernel of a call "
          "beside cuDNN's backward (events; device, from the same session as ours); then the dh "
          "loop's µs a step; then the compositional chain's ms a step")
    for key in runs[0][1]["rows"]:
        cells = []
        for name, r in runs:
            row = r["rows"][key]
            cells.append(f"{name} {row['device']:.4f} ({row['dh_loop']:.4f}), {row['ms']:.4f}"
                         + (f", call {row['call_device_ms']:.4f}, cuDNN {row['cudnn_ms']:.4f} "
                            f"(device {row['cudnn_device_ms']:.4f})" if "cudnn_ms" in row else "")
                         + (f" [R={row['tile']['R']}, {row['tile']['waves']} waves]"
                            if row["tile"] else ""))
        print(f"{key}: " + " | ".join(cells))
    for key in runs[0][1]["steps"]:
        print(f"dh step {key}: " + " | ".join(
            f"{name} {r['steps'][key]['us']:.3f}"
            + (f" [R={r['steps'][key]['tile']['R']}]" if r["steps"][key]["tile"] else "")
            for name, r in runs))
    if runs[0][1]["chain_ms"] is not None:
        print("compositional chain at hidden 256, ms a step: "
              + " | ".join(f"{name} {r['chain_ms']:.3f}" for name, r in runs))
    if out:
        with open(out, "w") as f:
            json.dump({"card": card, "runs": runs}, f, indent=1)


if __name__ == "__main__":
    main()
