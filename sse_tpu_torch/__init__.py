"""sse_tpu_torch — the PyTorch / CUDA port of ``sse_tpu``.

Same layout and names as ``sse_tpu/`` so each module's counterpart is
easy to find; PyTorch idiom inside (``nn``-free plain functions over
tensor dicts, an explicit ``device`` everywhere, ``torch.Generator`` for
init, dropout and negative sampling). Every kernel that ``sse_tpu``
wrote in Pallas for the TPU is a hand-written CUDA C++ kernel for Hopper (``sse_tpu_torch/csrc``), built
with ``nvcc`` on first CUDA use (``sse_tpu_torch.ops._build``). On CPU
tensors each kernel wrapper runs its plain PyTorch version instead; on a
CUDA tensor it launches the kernel or raises — there is no fallback.

Ported so far: the serving path (GRU or LSTM tower with the final,
mean or attention readout → index → fused top-k, packed or exact →
HTTP), the training path (differentiable recurrent towers whose backward
is a hand-written kernel, losses, clip-then-Adam, the train loop, the
recall Evaluator, the task presets) and the model-dir path (checkpoints,
index persistence, ``workspace``, ``python -m sse_tpu_torch.cli``). What
is still to port is listed in ROADMAP.md.

The host layers (``text``, ``data``) are the port's own copies of
``sse_tpu.text`` and ``sse_tpu.data``: nothing in this package imports
``jax`` or any module of ``sse_tpu``.
"""
