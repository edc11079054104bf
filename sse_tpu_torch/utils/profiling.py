"""Profiler trace of a run, a live profiler endpoint, a steps/sec timer
(port of ``sse_tpu/utils/profiling.py``: ``trace``, which ``train
--profile_dir`` uses, ``start_profiler_server`` and ``StepTimer``) and
the program's named host spans (``span``). ``trace`` is a
``torch.profiler`` context that writes a Chrome trace (open it in
Perfetto or chrome://tracing) into a directory.

``span(name)`` names a part of the program's host path. While a torch
profiler runs (``trace``, ``/profile``, any ``torch.profiler.profile``)
or a ``record_spans()`` block is open, it opens the profiler range
``"sse." + name`` (on the profiler's clock, beside the kernels it
launched) and adds its duration and self time to per-name totals,
``span_totals()``. A span's duration leaves out its own bookkeeping; its
self time also leaves out what its child spans cover, their bookkeeping
included, so it holds only the span's own code. Otherwise it costs
a flag check: one shared no-op context, no allocation and no torch op.
The stack of open spans is a thread's own; the outermost span of a call
carries the call's sequence number as its range's argument (a trace that
records shapes shows it as the range's "Concrete Inputs"), and the spans
of that call nest inside it on its thread."""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Iterator, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._autograd import _record_function_with_args_enter, _record_function_with_args_exit

_OFF = contextlib.nullcontext()
_recording = 0  # open record_spans() blocks, all threads
_totals: Dict[str, list] = {}  # range name -> [count, total ns, self ns]
_totals_lock = threading.Lock()
_local = threading.local()  # .stack: this thread's open spans
_calls = itertools.count()


class _Span:
    """One recorded span: a user-scope profiler range (``record_function``'s
    kind, entered through the binding that takes the call's number as an
    int, which a trace with ``record_shapes=True`` shows among the range's
    inputs) and its share of the totals."""

    __slots__ = ("name", "range", "opened", "t0", "children")

    def __init__(self, name: str) -> None:
        self.name = "sse." + name

    def __enter__(self) -> "_Span":
        self.opened = time.perf_counter_ns()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            self.range = _record_function_with_args_enter(self.name)
        else:
            self.range = _record_function_with_args_enter(self.name, next(_calls))
        self.children = 0
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        took = time.perf_counter_ns() - self.t0
        stack = _local.stack
        stack.pop()
        _record_function_with_args_exit(self.range)
        with _totals_lock:
            got = _totals.setdefault(self.name, [0, 0, 0])
            got[0] += 1
            got[1] += took
            got[2] += took - self.children
        if stack:  # the parent's self time leaves out this span and what it cost
            stack[-1].children += time.perf_counter_ns() - self.opened


def span(name: str):
    """The host span ``"sse." + name`` as a context manager: recorded
    while a torch profiler runs or a ``record_spans()`` block is open,
    else a shared no-op context."""
    if _recording or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


@contextlib.contextmanager
def record_spans() -> Iterator[None]:
    """Record spans (ranges and totals) without a profiler."""
    global _recording
    with _totals_lock:
        _recording += 1
    try:
        yield
    finally:
        with _totals_lock:
            _recording -= 1


def span_totals() -> Dict[str, Tuple[int, float, float]]:
    """{range name: (count, total seconds, self seconds)} of the spans
    recorded since the last ``reset_spans()``."""
    with _totals_lock:
        return {k: (c, t / 1e9, s / 1e9) for k, (c, t, s) in _totals.items()}


def reset_spans() -> None:
    with _totals_lock:
        _totals.clear()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the host and, where there is a card, the device, and write
    ``<log_dir>/trace_<pid>_<time>.json`` on exit::

        with sse_tpu_torch.utils.trace("/tmp/trace"):
            state = train(...)
    """
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the device work of the run ends inside
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time())}.json")
    )


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _all_threads():
    """A profiler config that records every thread's ops (the capture runs
    on the server's thread), where this torch offers one."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:  # a torch without the option records its own thread only
        return None


def start_profiler_server(port: int = 9999, log_dir: str = "profiles",
                          host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """A live profiler endpoint on ``host:port`` (the counterpart of
    ``jax.profiler.start_server``, which captures on TensorBoard's
    request): ``GET /profile?duration_ms=N[&log_dir=DIR]`` profiles this
    process (host and, where there is a card, device) for N ms, writes a
    Chrome trace into DIR (``log_dir`` by default) and answers
    ``{"trace": path}``; 409 while another capture runs. The server runs
    on a daemon thread; ``shutdown()`` stops it."""
    busy = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # no access log on stderr
            pass

        def _answer(self, code: int, body: dict) -> None:
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802 (the http.server hook's name)
            url = urllib.parse.urlparse(self.path)
            if url.path != "/profile":
                return self._answer(404, {"error": f"no route {url.path}"})
            q = urllib.parse.parse_qs(url.query)
            try:
                ms = float(q.get("duration_ms", ["1000"])[0])
            except ValueError:
                return self._answer(400, {"error": "duration_ms must be a number"})
            out_dir = q.get("log_dir", [log_dir])[0]
            if not busy.acquire(blocking=False):
                return self._answer(409, {"error": "a capture is running"})
            try:
                os.makedirs(out_dir, exist_ok=True)
                with torch.profiler.profile(activities=_activities(),
                                            experimental_config=_all_threads()) as prof:
                    time.sleep(ms / 1000.0)
                    if torch.cuda.is_available():
                        torch.cuda.synchronize()
                path = os.path.join(out_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
                prof.export_chrome_trace(path)
            finally:
                busy.release()
            return self._answer(200, {"trace": path})

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, name="sse-profiler", daemon=True).start()
    return server


def wait_for(out: Any) -> None:
    """Block until the device work that produced ``out`` (a tensor, or a
    tuple, list or dict of them) has finished: ``torch.cuda.synchronize``
    of each CUDA device it lives on. CPU tensors are ready when returned."""
    if torch.is_tensor(out):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            wait_for(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            wait_for(v)


class StepTimer:
    """Wall-clock steps/sec with an explicit completion barrier: PyTorch
    returns before the card finishes, so callers pass the step output and
    ``step`` waits for the device it lives on."""

    def __init__(self):
        self.reset()

    def step(self, out: Any = None) -> None:
        if out is not None:
            wait_for(out)
        self._steps += 1

    def rate(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else 0.0

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0
