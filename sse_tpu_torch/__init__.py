"""sse_tpu_torch — the PyTorch / CUDA port of ``sse_tpu``.

Same layout and names as ``sse_tpu/`` so each module's counterpart is
easy to find; PyTorch idiom inside (``nn``-free plain functions over
tensor dicts, an explicit ``device`` everywhere, ``torch.Generator`` for
init). Every kernel that ``sse_tpu`` wrote in Pallas for the TPU is a
hand-written CUDA C++ kernel for Hopper (``sse_tpu_torch/csrc``), built
with ``nvcc`` on first CUDA use (``sse_tpu_torch.ops._build``). On CPU
tensors each kernel wrapper runs its plain PyTorch version instead; on a
CUDA tensor it launches the kernel or raises — there is no fallback.

Ported so far: the serving path (GRU tower → index → fused top-k →
HTTP). What is still to port is listed in ROADMAP.md.

The JAX-free host layers are reused by import, never copied:
``sse_tpu.text``, ``sse_tpu.data`` and ``sse_tpu.native``. Nothing in
this package imports ``jax``.
"""
