"""Profiler trace of a run, a live profiler endpoint and a steps/sec
timer (port of ``sse_tpu/utils/profiling.py``: ``trace``, which ``train
--profile_dir`` uses, ``start_profiler_server`` and ``StepTimer``).
``trace`` is a ``torch.profiler`` context that writes a Chrome trace (open
it in Perfetto or chrome://tracing) into a directory."""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Iterator

import torch


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
