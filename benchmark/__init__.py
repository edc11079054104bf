"""The benchmark of ``sse_tpu_torch`` on NVIDIA cards: ``run.py`` runs one
cell of ``BENCHMARK.json``."""
