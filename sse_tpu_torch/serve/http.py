"""HTTP front end over the port's QueryEngine (port of
``sse_tpu/serve/http.py``). stdlib only (ThreadingHTTPServer): GET and
POST /api/query, GET /healthz, /api/stats (JSON), /metrics (Prometheus
text), POST /api/add and /api/delete; POST /api/save (persist live adds
and deletes to ``index_dir``) and POST /api/reload (rebuild the engine
from ``model_dir``'s latest checkpoint and saved index, swapped in while
queries keep running on the old one)."""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from sse_tpu_torch import ops
from sse_tpu_torch.serve.engine import QueryEngine
from sse_tpu_torch.serve.stats import ServingStats

# Request-body hardening (the reference's webserver trusted the network;
# a "production default" front end must not): a single oversized POST is
# rejected with 413 BEFORE the body is read into memory, mutation batches
# are bounded, and non-JSON content types get 415.
MAX_BODY_BYTES = 16 << 20  # 16 MiB — far above any sane query/add batch
MAX_DOCS_PER_REQUEST = 4096  # /api/add & /api/delete per-call bound


class _HttpError(Exception):
    """Request-level error carrying its HTTP status code."""

    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code
        self.msg = msg

_DEMO_PAGE = """<!doctype html>
<html><head><title>SSE demo</title></head>
<body style="font-family:sans-serif;max-width:40em;margin:2em auto">
<h2>Sequence Semantic Embedding demo</h2>
<form action="/api/query"><input name="keywords" size="40"
 placeholder="type a query"><input type="submit" value="search"></form>
<p>API: <code>GET /api/query?keywords=...&amp;n=10</code></p>
</body></html>"""


def make_handler(
    engine,
    index_dir: Optional[str] = None,
    model_dir: Optional[str] = None,
):
    """`engine` is a QueryEngine or a MicroBatcher wrapping one.
    `index_dir` enables POST /api/save, `model_dir` POST /api/reload."""
    from sse_tpu_torch.serve.batcher import MicroBatcher

    batcher = engine if isinstance(engine, MicroBatcher) else None
    if batcher is not None:
        engine = batcher.engine
    lock = threading.Lock()  # non-batched fallback: serialize device access
    stats = ServingStats()
    reload_lock = threading.Lock()  # serializes concurrent /api/reload

    def reload_engine():
        """Build a fresh engine from what is on disk in model_dir (latest
        checkpoint, saved index) and swap it in. The build and warmup run
        outside the handler lock, so queries and mutations keep flowing on
        the old engine; only the swap takes the lock. In-flight queries
        finish on the old engine; live adds and deletes not saved with
        POST /api/save are discarded (disk is the source of truth)."""
        nonlocal engine
        from sse_tpu_torch.workspace import Workspace  # lazy: avoids the cycle

        with reload_lock:
            ws = Workspace.open(model_dir, device=engine.device)
            new_engine = ws.engine(
                k=engine.requested_k,
                max_batch=engine.max_batch,
                bulk_batch=engine.bulk_batch,
            )
            new_engine.warmup()
            with lock:  # atomic swap only
                if batcher is not None:
                    batcher.engine = new_engine  # _loop reads it per batch
                engine = new_engine
        return new_engine

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_error(self, e: "_HttpError"):
            self._send(
                e.code,
                json.dumps({"error": e.msg}).encode(),
                "application/json",
            )

        def _json_body(self):
            """Parse the JSON request body with the hardening gates:
            oversized bodies 413 WITHOUT reading them, wrong content type
            415, malformed JSON 400 (raised as _HttpError)."""
            ctype = (
                (self.headers.get("Content-Type") or "application/json")
                .split(";")[0]
                .strip()
                .lower()
            )
            # x-www-form-urlencoded is what urllib/curl -d send when the
            # caller doesn't set a type — treat it as "unspecified" (the
            # body is still parsed as JSON); everything else is 415
            if ctype not in (
                "",
                "application/json",
                "text/json",
                "application/x-www-form-urlencoded",
            ):
                raise _HttpError(
                    415, f"unsupported content type: {ctype} (send JSON)"
                )
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                raise _HttpError(400, "bad Content-Length header")
            if length > MAX_BODY_BYTES:
                raise _HttpError(
                    413,
                    f"body too large: {length} > {MAX_BODY_BYTES} bytes",
                )
            try:
                return json.loads(self.rfile.read(length))
            except Exception as e:
                raise _HttpError(400, f"bad body: {e}")

        def do_GET(self):  # noqa: N802 (stdlib API name)
            url = urlparse(self.path)
            if url.path == "/healthz":
                self._send(200, b'{"status": "ok"}', "application/json")
                return
            if url.path == "/api/stats":
                snap = stats.snapshot()
                snap["index_num_targets"] = engine.index.num_real
                # the engine's graph captures and replays beside the
                # kernels' launch counts (each replay adds its launches;
                # on a grid a dispatch replays one graph a card)
                snap.update(engine.graph_counts())
                snap["kernel_launches"] = ops.launch_counts()
                self._send(
                    200, json.dumps(snap).encode(), "application/json"
                )
                return
            if url.path == "/metrics":
                body = stats.prometheus(
                    {"index_num_targets": engine.index.num_real, **engine.graph_counts()}
                ).encode()
                self._send(
                    200, body, "text/plain; version=0.0.4; charset=utf-8"
                )
                return
            if url.path == "/":
                self._send(200, _DEMO_PAGE.encode(), "text/html; charset=utf-8")
                return
            if url.path in ("/api/query", "/api/classify", "/api/search"):
                qs = parse_qs(url.query)
                keywords = (qs.get("keywords") or qs.get("q") or [""])[0]
                if not keywords.strip():
                    self._send(
                        400,
                        json.dumps({"error": "missing ?keywords="}).encode(),
                        "application/json",
                    )
                    return
                try:
                    n = int((qs.get("n") or [str(engine.k)])[0])
                except ValueError:
                    n = engine.k
                n = max(1, min(n, engine.k))
                t0 = time.perf_counter()
                try:
                    if batcher is not None:
                        hits = batcher.query_one(keywords, timeout=120)[:n]
                    else:
                        with lock:
                            hits = engine.query([keywords])[0][:n]
                except Exception as e:  # engine/device failure → JSON 500
                    stats.record_error()
                    self._send(
                        500,
                        json.dumps({"error": f"query failed: {e}"}).encode(),
                        "application/json",
                    )
                    return
                stats.record_query(time.perf_counter() - t0)
                body = json.dumps(
                    {"query": keywords, "results": hits}, ensure_ascii=False
                ).encode()
                self._send(200, body, "application/json")
                return
            self._send(404, b'{"error": "not found"}', "application/json")

        def do_POST(self):  # noqa: N802 (stdlib API name)
            url = urlparse(self.path)
            if url.path == "/api/query":
                # batch query for bulk clients: ["q1", "q2", ...] (or
                # {"queries": [...]}) → {"results": [[hits...], ...]},
                # one device batch instead of N HTTP round trips
                try:
                    body = self._json_body()
                    if isinstance(body, dict):
                        body = body["queries"]
                    # a bare JSON string would iterate into per-CHARACTER
                    # queries and 200 with nonsense — require a list
                    if not isinstance(body, list):
                        raise ValueError("expected a JSON list of queries")
                    texts = [str(t) for t in body]
                    if not texts:
                        raise ValueError("empty query list")
                except _HttpError as e:
                    self._send_error(e)
                    return
                except Exception as e:
                    self._send(
                        400,
                        json.dumps({"error": f"bad body: {e}"}).encode(),
                        "application/json",
                    )
                    return
                t0 = time.perf_counter()
                try:
                    if batcher is not None:
                        # through the single dispatch loop — bulk requests
                        # batch on-device and interleave fairly with
                        # concurrent singles; the engine is never touched
                        # from handler threads
                        results = batcher.query_many(texts, timeout=300)
                    else:
                        with lock:
                            results = engine.query(texts)
                except Exception as e:
                    stats.record_error()
                    self._send(
                        500,
                        json.dumps({"error": f"query failed: {e}"}).encode(),
                        "application/json",
                    )
                    return
                stats.record_query(
                    time.perf_counter() - t0, n_queries=len(texts)
                )
                self._send(
                    200,
                    json.dumps(
                        {"results": results}, ensure_ascii=False
                    ).encode(),
                    "application/json",
                )
                return
            if url.path == "/api/save":
                # persist live adds/deletes (they are otherwise volatile)
                if index_dir is None:
                    self._send(
                        400,
                        b'{"error": "server started without an index_dir"}',
                        "application/json",
                    )
                    return
                try:
                    with lock:
                        engine.index.save(index_dir)
                        n = engine.index.num_real
                except Exception as e:
                    self._send(
                        500,
                        json.dumps({"error": str(e)}).encode(),
                        "application/json",
                    )
                    return
                self._send(
                    200,
                    json.dumps({"saved": index_dir, "num_targets": n}).encode(),
                    "application/json",
                )
                return
            if url.path == "/api/reload":
                # hot model/index reload: retrain and rebuild offline, then
                # POST /api/reload; connections are never dropped
                if model_dir is None:
                    self._send(
                        400,
                        b'{"error": "server started without a model_dir"}',
                        "application/json",
                    )
                    return
                try:
                    new_engine = reload_engine()  # locks internally
                    n = new_engine.index.num_real
                except Exception as e:
                    self._send(
                        500,
                        json.dumps({"error": f"reload failed: {e}"}).encode(),
                        "application/json",
                    )
                    return
                stats.record_reload()
                self._send(
                    200,
                    json.dumps({"reloaded": model_dir, "num_targets": n}).encode(),
                    "application/json",
                )
                return
            if url.path == "/api/delete":
                # body: ["id1", "id2", ...] or [{"targetId": ...}, ...]
                try:
                    body = self._json_body()
                    if not isinstance(body, list):
                        raise ValueError("expected a JSON list of ids")
                    if len(body) > MAX_DOCS_PER_REQUEST:
                        raise _HttpError(
                            413,
                            f"too many ids: {len(body)} > "
                            f"{MAX_DOCS_PER_REQUEST} per request",
                        )
                    ids = [
                        d["targetId"] if isinstance(d, dict) else str(d)
                        for d in body
                    ]
                except _HttpError as e:
                    self._send_error(e)
                    return
                except Exception as e:
                    self._send(
                        400,
                        json.dumps({"error": f"bad body: {e}"}).encode(),
                        "application/json",
                    )
                    return
                try:
                    with lock:
                        n = engine.delete_documents(ids)
                except (KeyError, ValueError) as e:
                    self._send(
                        400,
                        json.dumps({"error": str(e)}).encode(),
                        "application/json",
                    )
                    return
                except Exception as e:  # device failure → JSON 500, not a
                    # dropped connection (r2 advisor: mirror /api/add)
                    stats.record_error()
                    self._send(
                        500,
                        json.dumps({"error": f"delete failed: {e}"}).encode(),
                        "application/json",
                    )
                    return
                self._send(
                    200,
                    json.dumps(
                        {"deleted": len(ids), "num_targets": n}
                    ).encode(),
                    "application/json",
                )
                return
            if url.path != "/api/add":
                self._send(404, b'{"error": "not found"}', "application/json")
                return
            try:
                docs = self._json_body()
                if not isinstance(docs, list):
                    raise ValueError("expected a JSON list of documents")
                if len(docs) > MAX_DOCS_PER_REQUEST:
                    raise _HttpError(
                        413,
                        f"too many documents: {len(docs)} > "
                        f"{MAX_DOCS_PER_REQUEST} per request",
                    )
                ids = [d["targetId"] for d in docs]
                texts = [d["targetText"] for d in docs]
            except _HttpError as e:
                self._send_error(e)
                return
            except Exception as e:
                self._send(
                    400,
                    json.dumps({"error": f"bad body: {e}"}).encode(),
                    "application/json",
                )
                return
            try:
                with lock:
                    n = engine.add_documents(ids, texts)
                stats.record_add(len(ids))
            except Exception as e:
                self._send(
                    400,
                    json.dumps({"error": str(e)}).encode(),
                    "application/json",
                )
                return
            self._send(
                200,
                json.dumps({"added": len(ids), "num_targets": n}).encode(),
                "application/json",
            )

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def serve_http(
    engine,
    host: str = "127.0.0.1",
    port: int = 8080,
    block: bool = True,
    micro_batch: bool = True,
    index_dir: Optional[str] = None,  # enables POST /api/save
    model_dir: Optional[str] = None,  # enables POST /api/reload
) -> Optional[ThreadingHTTPServer]:
    """`micro_batch=True` coalesces concurrent requests into device
    batches (sse_tpu_torch.serve.batcher) — the production default."""
    from sse_tpu_torch.serve.batcher import MicroBatcher

    if micro_batch and isinstance(engine, QueryEngine):
        engine = MicroBatcher(engine)
    server = ThreadingHTTPServer(
        (host, port),
        make_handler(engine, index_dir=index_dir, model_dir=model_dir),
    )
    if block:
        # SIGTERM == Ctrl-C for container/orchestrator deployments: stop
        # accepting, finish in-flight handlers, close the socket
        import signal

        def _term(signum, frame):  # noqa: ARG001
            raise KeyboardInterrupt

        prev = signal.signal(signal.SIGTERM, _term)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            signal.signal(signal.SIGTERM, prev)
            server.server_close()
        return None
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
