"""Two trees of the port, timed in turns on one CUDA card: the wide
recurrent forwards and the cluster scan's cost a step.

    python3 tools/wide_fwd_turns.py PARENT CHANGE [MORE ...]   # needs one CUDA card
    python3 tools/wide_fwd_turns.py --steps PARENT CHANGE ...    # the scan steps alone

PARENT, CHANGE (and any more) are checkouts of the repository (``git
archive``). The script runs them in turns, forward then backward (parent,
change, change, parent), each in a process of its own that imports that
tree's ``sse_tpu_torch`` (the measuring code is this file's and this
repository's ``chip_smoke.py`` helpers, the same for every tree). Each
process measures, at T=50, E=128, Glorot weights:

- the split layer forward (``rnn.rnn_layer``: the x-product, then the
  cluster scan) of the GRU and the LSTM at H=256 and 384, B=4096, ragged
  lengths: held against the plain version (``chip_smoke.hold_layer``),
  its time (CUDA events), its device time by part (torch.profiler: scan,
  x-product) and, for the LSTM, cuDNN's ``torch.nn.LSTM`` at the same
  shape (full lengths): its CUDA-event time, and the device time of every
  kernel of one call of each, the two run in turns in one profiler
  session (``chip_smoke.call_device_ms``);
- the scan alone (``rnn.scan_layer``) of either cell at H=256, full
  lengths, B=8, 256 and 4096: µs a step, the slope of its device time
  over T=1, 2, 50.

Prints one line a tree and run, the table of the four runs, and the card's
name and power limit. ``--out FILE`` also writes the runs as JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ROWS = (("gru", 256), ("lstm", 256), ("gru", 384), ("lstm", 384))
STEP_BATCHES = (8, 256, 4096)


def measure(tree: str, rows: bool = True) -> dict:
    """The readings of one tree, in this process (its sse_tpu_torch first
    on the path); ``rows`` False: the scan steps alone."""
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
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 21)
    T, E, B = 50, 128, 4096
    out = {"rows": {}, "steps": {}}
    for cell, H in ROWS if rows else ():
        G = 4 if cell == "lstm" else 3
        wx, wh, b = smoke.glorot_weights(E, H, G, gen)
        xs = torch.randn((T, B, E), generator=gen, device="cuda").bfloat16()
        args = (xs, smoke.ragged_mask(T, B, gen), wx, wh, b)
        got = rnn.rnn_layer(*args, cell)
        smoke.hold_layer(f"{cell} H={H}", got, rnn.rnn_layer_reference(*args, cell)[:2])
        run = lambda: rnn.rnn_layer(*args, cell=cell)  # noqa: E731
        lib, calls = None, {"ours": run}
        if cell == "lstm":
            lstm = smoke.cudnn_lstm(wx, wh, b)

            def cudnn_call():
                with torch.no_grad():
                    return lstm(xs)

            lib = smoke.cuda_ms(cudnn_call)
            calls["cudnn"] = cudnn_call
        both = smoke.call_device_ms(calls)
        out["rows"][f"{cell} {H}"] = dict(ms=smoke.cuda_ms(run),
                                          device=smoke.parts_ms(run, smoke.SCAN_PARTS),
                                          call_device_ms=both["ours"], cudnn_lstm_ms=lib,
                                          cudnn_lstm_device_ms=both.get("cudnn"))
        del got, args, xs
        torch.cuda.empty_cache()
    for cell, G in (("gru", 3), ("lstm", 4)):
        wh = smoke.glorot_weights(E, 256, G, gen)[1]
        for B in STEP_BATCHES:
            ms = {}
            for T in (1, 2, 50):
                ax = torch.randn((T, B, G * 256), generator=gen, device="cuda")
                mask = torch.ones((T, 1, B), device="cuda")
                ms[T] = smoke.kernel_ms(lambda: rnn.scan_layer(ax, mask, wh, cell), "rnn_scan_")
            ts = sorted(ms)
            mt, mm = sum(ts) / len(ts), sum(ms.values()) / len(ts)
            slope = (sum((t - mt) * (ms[t] - mm) for t in ts)
                     / sum((t - mt) ** 2 for t in ts))
            out["steps"][f"{cell} {B}"] = 1000.0 * slope
    return out


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
    print(f"[{card}] device ms (scan + x-product) at B=4096, T=50, E=128; ms (CUDA events); "
          "device ms of every kernel of a call; cuDNN LSTM ms (CUDA events; device, from the "
          "same session as ours); then scan µs a step at H=256 (B=8/256/4096)")
    for key in runs[0][1]["rows"]:
        cells = []
        for name, r in runs:
            row = r["rows"][key]
            dev = sum(row["device"].values())
            lib = row["cudnn_lstm_ms"]
            cells.append(f"{name} {dev:.4f} ({row['device']['scan']:.4f} + "
                         f"{row['device']['x-product']:.4f}), {row['ms']:.4f}, call "
                         f"{row['call_device_ms']:.4f}"
                         + ("" if lib is None else
                            f", cuDNN {lib:.4f} (device {row['cudnn_lstm_device_ms']:.4f})"))
        print(f"{key}: " + " | ".join(cells))
    for key in runs[0][1]["steps"]:
        print(f"scan step {key}: " + " | ".join(f"{name} {r['steps'][key]:.3f}"
                                                for name, r in runs))
    if out:
        with open(out, "w") as f:
            json.dump({"card": card, "runs": runs}, f, indent=1)


if __name__ == "__main__":
    main()
