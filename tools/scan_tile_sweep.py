"""The cluster scan on every tile it can take, on a CUDA card: device ms of
``rnn.rnn_scan_launch`` at T=50, full lengths, for each cluster size C
that takes H and each row count R a cluster of C blocks can carry, beside
the tile the launch picks by itself (``rnn.card_scan_tile``).

    python3 tools/scan_tile_sweep.py [B ...]   # needs one CUDA card; B: 256 4096

For the GRU and the LSTM at H=256 and 384 (E=128's plans), prints one
line a (cell, H, B): ms by (C, R) with the waves of the card's active
clusters, the fastest tile and the launch's own, with the card's name and
power limit. Device time from torch.profiler (chip_smoke.kernel_ms).
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("scan_tile_sweep: no CUDA device", file=sys.stderr)
        sys.exit(2)
    import chip_smoke as smoke
    from sse_tpu_torch.ops import rnn

    batches = [int(b) for b in sys.argv[1:]] or [256, 4096]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    smoke.set_flags()
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 24)
    T = 50
    for cell, G in (("lstm", 4), ("gru", 3)):
        for H in (256, 384):
            plan = rnn.layer_plan(cell, 128, H)
            wh = smoke.glorot_weights(128, H, G, gen)[1]
            sizes = [c for c in rnn.CLUSTERS
                     if c >= plan.scan_cluster and rnn._refusal("scan", G, H, c) is None]
            for B in batches:
                ax = torch.randn((T, B, G * H), generator=gen, device="cuda")
                mask = torch.ones((T, 1, B), device="cuda")
                own = rnn.card_scan_tile(dev, G, H, B, plan.scan_cluster)
                times = {}
                for C in sizes:
                    n = rnn.active_clusters(dev, G, H, C)
                    for R in range(8, rnn.scan_rows_most(G, H, C) + 1, 8):
                        waves = -(-(-(-B // R)) // n)
                        if R > 8 and -(-B // (R - 8)) == -(-B // R):
                            continue  # the same clusters as a smaller R
                        ms = smoke.kernel_ms(
                            lambda: rnn.rnn_scan_launch(ax, mask, wh, cell, C, _rows=R),
                            "rnn_scan_")
                        times[(C, R)] = (ms, waves, n)
                best = min(times, key=lambda k: times[k][0])
                print(f"{cell} H={H} B={B} T={T}: "
                      + ", ".join(f"C={c} R={r} {ms:.4f} ms ({w} waves of {n})"
                                  for (c, r), (ms, w, n) in sorted(times.items()))
                      + f"; fastest C={best[0]} R={best[1]}; the launch's C={own.C} R={own.R} "
                      f"({own.waves} waves) [{card}]", flush=True)
                del ax
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
