"""The port's C++ subword encoder (a copy of the JAX package's
``sse_tpu/native``): encoding, token counting and the vocab build in
native code, bit-identical to ``sse_tpu_torch.text.subword``.

``encoder.cpp`` is built with the host C++ compiler into
``build/sse_tpu_torch/`` at first use (``binding.build_library``). Unlike
the JAX package, the port does not fall back to Python when the build
fails: it raises with the compiler's stderr.
"""

from sse_tpu_torch.native.binding import (
    NativeSubwordEncoder,
    build_library,
    native_available,
    native_build_subtokens,
    native_token_counts,
)

__all__ = [
    "NativeSubwordEncoder",
    "build_library",
    "native_available",
    "native_build_subtokens",
    "native_token_counts",
]
