"""ctypes binding of the port's C++ subword encoder (``encoder.cpp``).

The library is compiled with the host C++ compiler (``c++``, else
``g++``) on the first call that needs it, never at import, into
``build/sse_tpu_torch/libsse_encoder_<hash>.so`` under a hash of the
source and the flags, never beside the source. A build holds a lock (a
thread lock, and a file lock so that concurrent processes build once)
and writes a temporary file that ``os.replace`` puts in place. A failed
build raises with the compiler's stderr: nothing here falls back to
Python. The plain versions stay callable on their own:
``SubwordVocab.encode``, ``token_counts_from_lines``,
``SubwordVocab.build_from_token_counts(use_native=False)`` and
``corpus.batch_encode_python``.

Strings cross as UTF-8 with ``surrogatepass``, so a lone surrogate is
one code point on both sides, as Python counts it.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import itertools
import os
import shutil
import subprocess
import sys
import threading
import time
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from sse_tpu_torch.text.subword import EOS_ID, RESERVED_TOKENS

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "encoder.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(SRC))), "build", "sse_tpu_torch"
)
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]
# seconds the last build in this process took (None: none built here)
build_info = {"seconds": None}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P32 = ctypes.POINTER(ctypes.c_int32)
_PU32 = ctypes.POINTER(ctypes.c_uint32)
_P64 = ctypes.POINTER(ctypes.c_int64)
_VOID, _PTR, _STR = None, ctypes.c_void_p, ctypes.c_char_p
_I32, _I64 = ctypes.c_int32, ctypes.c_int64
# C entry point → (restype, argtypes), as encoder.cpp declares them
_SIGNATURES = {
    "sse_counter_create": (_PTR, [_PU32, _I32]),
    "sse_counter_add": (_VOID, [_PTR, _STR, _P64, _I32]),
    "sse_counter_sizes": (_VOID, [_PTR, _P64, _P64]),
    "sse_counter_dump": (_VOID, [_PTR, _STR, _P32, _P64]),
    "sse_counter_destroy": (_VOID, [_PTR]),
    "sse_vocab_build": (_PTR, [_STR, _P64, _P64, _I64, _I64, _I32, _I32]),
    "sse_vocab_sizes": (_VOID, [_PTR, _P64, _P64]),
    "sse_vocab_dump": (_VOID, [_PTR, _STR, _P32]),
    "sse_vocab_destroy": (_VOID, [_PTR]),
    "sse_encoder_create": (_PTR, [_STR, _P32, _I32, _I32, _PU32, _I32]),
    "sse_encoder_destroy": (_VOID, [_PTR]),
    "sse_encode": (_I32, [_PTR, _STR, _I32, _P32, _I32]),
    "sse_encode_batch": (_VOID, [_PTR, _STR, _P64, _I32, _I32, _I32, _P32, _P32]),
}


def _compiler() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError(
        "no host C++ compiler (c++ or g++ on PATH): the subword encoder "
        "cannot be built"
    )


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsse_encoder_{h.hexdigest()[:16]}.so")


def build_library(quiet: bool = True) -> str:
    """Compile encoder.cpp into the shared library, once per source and
    flags, and return its path. Raises RuntimeError with the compiler's
    stderr when the build fails. ``quiet=False`` prints the command and
    what the compiler said on stderr."""
    path = _lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "libsse_encoder.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(path):  # another process built it meanwhile
            return path
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [_compiler(), *CXX_FLAGS, SRC, "-o", tmp]
        t0 = time.perf_counter()
        done = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if not quiet:
            print(" ".join(cmd), done.stdout, done.stderr, sep="\n", file=sys.stderr)
        if done.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"the subword encoder's build failed ({done.returncode}): "
                f"{' '.join(cmd)}\n{done.stderr}"
            )
        os.replace(tmp, path)
        build_info["seconds"] = time.perf_counter() - t0
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def native_available() -> bool:
    """True when the library builds and loads here. The port's own
    callers do not ask: they call the library, and a failed build
    raises."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


@functools.lru_cache(maxsize=None)
def _alnum_ranges() -> np.ndarray:
    """[n, 2] uint32 code point ranges of the unicode L* and N*
    categories, from Python's unicodedata, so that both sides split runs
    on the same characters (the tokenizer's rule)."""
    ranges: List[Tuple[int, int]] = []
    start = None
    for cp in range(sys.maxunicode + 1):
        is_alnum = unicodedata.category(chr(cp)).startswith(("L", "N"))
        if is_alnum and start is None:
            start = cp
        elif not is_alnum and start is not None:
            ranges.append((start, cp - 1))
            start = None
    if start is not None:
        ranges.append((start, sys.maxunicode))
    return np.asarray(ranges, dtype=np.uint32)


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _pack(texts: Sequence[str]) -> Tuple[bytes, np.ndarray]:
    """Concatenated UTF-8 bytes of ``texts`` and their n+1 offsets."""
    raws = [t.encode("utf-8", "surrogatepass") for t in texts]
    offsets = np.zeros((len(raws) + 1,), dtype=np.int64)
    np.cumsum([len(r) for r in raws], out=offsets[1:])
    return b"".join(raws), offsets


def _dump(lib, prefix: str, handle, with_counts: bool):
    """The strings (and counts) of a counter or vocab handle, through its
    two-phase sizes/dump calls."""
    n, total = ctypes.c_int64(), ctypes.c_int64()
    getattr(lib, f"{prefix}_sizes")(handle, ctypes.byref(n), ctypes.byref(total))
    blob = ctypes.create_string_buffer(max(total.value, 1))
    lens = np.zeros((max(n.value, 1),), dtype=np.int32)
    counts = np.zeros((max(n.value, 1),), dtype=np.int64)
    extra = (_ptr(counts, ctypes.c_int64),) if with_counts else ()
    getattr(lib, f"{prefix}_dump")(handle, blob, _ptr(lens, ctypes.c_int32), *extra)
    raw, pos, out = blob.raw, 0, []
    for ln in lens[: n.value].tolist():
        out.append(raw[pos : pos + ln].decode("utf-8", "surrogatepass"))
        pos += ln
    return out, counts[: n.value].tolist()


def native_token_counts(lines: Iterable[str]) -> Dict[str, int]:
    """C++ tokenize-and-count over corpus lines: the same dict as
    ``token_counts_from_lines``. ``lines`` may be a generator; it is read
    65,536 lines at a time."""
    lib = _load()
    ranges = _alnum_ranges()
    handle = lib.sse_counter_create(_ptr(ranges, ctypes.c_uint32), ranges.shape[0])
    try:
        it = iter(lines)
        while True:
            chunk = list(itertools.islice(it, 65536))
            if not chunk:
                break
            blob, offsets = _pack(chunk)
            lib.sse_counter_add(handle, blob, _ptr(offsets, ctypes.c_int64), len(chunk))
        tokens, counts = _dump(lib, "sse_counter", handle, with_counts=True)
        return dict(zip(tokens, counts))
    finally:
        lib.sse_counter_destroy(handle)


def native_build_subtokens(
    token_counts: Dict[str, int],
    min_count: int,
    num_iterations: int = 4,
    max_subtoken_length: Optional[int] = None,
) -> List[str]:
    """C++ ``build_from_token_counts``: the ordered subtokens (reserved
    ids excluded) of the vocab that the pure-Python build makes from the
    same arguments, bit for bit. ``max_subtoken_length`` None or 0 means
    unbounded."""
    lib = _load()
    toks = list(token_counts)
    blob, offsets = _pack(toks)
    counts = np.asarray([token_counts[t] for t in toks], dtype=np.int64)
    handle = lib.sse_vocab_build(
        blob, _ptr(offsets, ctypes.c_int64), _ptr(counts, ctypes.c_int64), len(toks),
        int(min_count), int(num_iterations), int(max_subtoken_length or 0),
    )
    try:
        return _dump(lib, "sse_vocab", handle, with_counts=False)[0]
    finally:
        lib.sse_vocab_destroy(handle)


class NativeSubwordEncoder:
    """C++ encoding with a ``SubwordVocab``'s subtokens: ``encode`` gives
    ``vocab.encode``'s ids, ``encode_batch`` the data layer's padded
    arrays. One instance may serve many threads at once: an encode reads
    the encoder and keeps its state on the call's own stack, and a ctypes
    call releases the GIL."""

    def __init__(self, vocab):
        self._lib = lib = _load()
        offset = len(RESERVED_TOKENS)
        subs = [
            vocab.id_to_subtoken(i).encode("utf-8", "surrogatepass")
            for i in range(offset, vocab.vocab_size)
        ]
        lens = np.asarray([len(s) for s in subs], dtype=np.int32)
        ranges = _alnum_ranges()
        self._handle = lib.sse_encoder_create(
            b"".join(subs), _ptr(lens, ctypes.c_int32), len(subs), offset,
            _ptr(ranges, ctypes.c_uint32), ranges.shape[0],
        )

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.sse_encoder_destroy(handle)
            self._handle = None

    def encode(self, text: str) -> List[int]:
        raw = text.encode("utf-8", "surrogatepass")
        # Escaping can emit up to 6 ids per input BYTE (a 1-char token of a
        # code point 100-127 outside the alphabet escapes to "\NNN;" plus
        # the trailing "_", 6 single-char subtokens), so size for the worst
        # case and retry bigger if the C side filled the buffer: sse_encode
        # truncates at capacity, and a full buffer is the only sign that it
        # may have.
        cap = len(raw) * 6 + 8
        while True:
            out = np.empty((cap,), dtype=np.int32)
            n = self._lib.sse_encode(self._handle, raw, len(raw), _ptr(out, ctypes.c_int32), cap)
            if n < cap:
                return out[:n].tolist()
            cap *= 4

    def encode_batch(
        self, texts: Sequence[str], max_len: int, eos_id: int = EOS_ID
    ) -> Tuple[np.ndarray, np.ndarray]:
        """([N, max_len] int32 tokens, [N] int32 lengths): each row's ids
        cut to ``max_len - 1``, then ``eos_id``, then zeros; the length
        counts the EOS (``corpus.batch_encode_python``'s convention)."""
        if max_len < 1:
            raise ValueError(f"max_len must be at least 1 (room for the EOS), got {max_len}")
        blob, offsets = _pack(texts)
        tokens = np.empty((len(texts), max_len), dtype=np.int32)
        lengths = np.empty((len(texts),), dtype=np.int32)
        self._lib.sse_encode_batch(
            self._handle, blob, _ptr(offsets, ctypes.c_int64), len(texts), max_len, eos_id,
            _ptr(tokens, ctypes.c_int32), _ptr(lengths, ctypes.c_int32),
        )
        return tokens, lengths
