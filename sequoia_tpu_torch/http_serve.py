"""HTTP serving: a resident SlidePredictor behind a JSON endpoint.

Counterpart of ``sequoia_tpu/http_serve.py``: the models and the backbone
load once, then each request streams its slides through the decode ->
screen -> features -> k-means -> ViS pipeline (cross-slide pipelined for
multi-slide requests).  Slides are referenced by path (a shared filesystem,
not request bodies).  Standard library only (``http.server``).

    POST /predict   {"wsi": "/data/slide.svs"} or {"wsi": [paths...]}
                    -> {"predictions": {name: {gene: value}},
                        "failed": {name: error}}
    GET  /genes     -> {"genes": [...], "n": G}
    GET  /healthz   -> {"status": "ok", "folds": k, "feat_type": ...}

Concurrent requests are merged, not serialized: every ``POST /predict``
enqueues its slide list and one pipeline worker drains everything pending
into one ``predict_slides`` run (slides from different clients pipeline
together, duplicate paths compute once).

Backpressure: admitted-but-unfinished slides are capped at
``max_pending_slides``; past it ``POST /predict`` returns 429 at once.
``request_timeout`` bounds how long a client blocks: on expiry the request
is abandoned (skipped if still queued, its results discarded if in flight)
and the client gets 504.  ``GET /healthz`` reports ``pending_slides`` so a
load balancer can shed load before the cap.  ``cli/serve.py --http`` builds
the predictor (with the serving kernel set of ``cli.serve.build_predictor``)
and runs this server.
"""

from __future__ import annotations

import json
import math
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def _jsonable(v) -> float | None:
    # json.dumps would emit a literal NaN/Infinity token (invalid
    # RFC-8259) and strict parsers would reject the WHOLE response
    f = float(v)
    return f if math.isfinite(f) else None


class ServiceOverloaded(RuntimeError):
    """Pending-slide cap reached; the client should retry later (429)."""


class RequestTimeout(RuntimeError):
    """The client's wait bound expired before its batch completed (504)."""


class _Request:
    """One client's pending slide list + its delivery slot."""

    __slots__ = ("paths", "results", "failed", "error", "done", "abandoned")

    def __init__(self, paths: list[str]):
        self.paths = paths
        self.results: dict[str, dict] = {}
        self.failed: dict[str, str] = {}
        self.error: BaseException | None = None
        self.done = threading.Event()
        # set by a timed-out owner: worker skips it if still queued
        self.abandoned = False


class PredictorService:
    """Thread-safe wrapper: one SlidePredictor, merged pipeline runs.

    All requests funnel through ``self._pending``; ``_worker`` drains every
    queued request into one merged ``predict_slides`` call.  ``predict``
    blocks until the worker delivers, so the handler-facing API stays
    synchronous."""

    def __init__(self, predictor, genes: list[str],
                 max_pending_slides: int = 256,
                 request_timeout: float | None = None):
        self.predictor = predictor
        self.genes = list(genes)
        self.max_pending_slides = int(max_pending_slides)
        self.request_timeout = request_timeout
        self.requests = 0
        self.slides_ok = 0
        self.slides_failed = 0
        self.rejected = 0
        self.timed_out = 0
        self.last_slide_seconds: float | None = None
        self._pending: "queue.Queue[_Request | None]" = queue.Queue()
        # admitted-but-unfinished slides (queued + in flight): the
        # backpressure counter behind the 429 cap
        self._pending_slides = 0
        # orders enqueues against close(): the shutdown sentinel is
        # guaranteed to be the LAST queue item, so no request can land
        # behind it and block its owner forever; also guards the stats
        # counters (mutated on the worker thread, read by health())
        self._lock = threading.Lock()
        self._closed = False
        self._worker = threading.Thread(target=self._serve_loop, daemon=True,
                                        name="predictor-service")
        self._worker.start()

    def close(self) -> None:
        """Stop the pipeline worker; requests already accepted (in-flight or
        queued) complete first, new ``predict`` calls are refused."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._pending.put(None)
        self._worker.join()

    def predict(self, paths: list[str],
                timeout: float | None = None) -> tuple[dict, dict]:
        """paths -> ({name: {gene: float}}, {name: error}); blocks until the
        merged pipeline run containing these slides completes.

        Raises :class:`ServiceOverloaded` when admitting these slides would
        push admitted-but-unfinished slides past ``max_pending_slides``, and
        :class:`RequestTimeout` when ``timeout`` (default
        ``self.request_timeout``; None = wait forever) expires first."""
        req = _Request([str(p) for p in paths])
        with self._lock:
            if self._closed:
                raise RuntimeError("PredictorService is closed")
            if (self._pending_slides + len(req.paths)
                    > self.max_pending_slides):
                self.rejected += 1
                raise ServiceOverloaded(
                    f"{self._pending_slides} slides already pending "
                    f"(+{len(req.paths)} would exceed the "
                    f"max_pending_slides={self.max_pending_slides} cap); "
                    "retry later")
            self._pending_slides += len(req.paths)
            self._pending.put(req)
        if timeout is None:
            timeout = self.request_timeout
        if not req.done.wait(timeout):
            # best effort: the worker skips still-queued abandoned requests
            # (freeing their slide budget without running them); an
            # in-flight batch finishes and its results are discarded
            req.abandoned = True
            with self._lock:
                self.timed_out += 1
            raise RequestTimeout(
                f"request not served within {timeout}s "
                f"({len(req.paths)} slides)")
        if req.error is not None:
            raise req.error
        return req.results, req.failed

    def _release(self, reqs) -> None:
        """Return finished/discarded requests' slides to the admission
        budget (the single decrement site for ``_pending_slides``)."""
        n = sum(len(r.paths) for r in reqs)
        if n:
            with self._lock:
                self._pending_slides -= n

    # -- worker -------------------------------------------------------------

    def _serve_loop(self) -> None:
        while True:
            first = self._pending.get()
            if first is None:
                return self._fail_remaining()
            batch = [first]
            while True:  # merge everything already waiting
                try:
                    nxt = self._pending.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._run_batch(batch)
                    return self._fail_remaining()
                batch.append(nxt)
            # timed-out owners are gone: skip their work, free their budget
            dropped = [r for r in batch if r.abandoned]
            if dropped:
                self._release(dropped)
                batch = [r for r in batch if not r.abandoned]
            if batch:
                self._run_batch(batch)

    def _fail_remaining(self) -> None:
        """Defense in depth at shutdown: the close() lock means nothing can
        follow the sentinel, but if anything ever did, fail it loudly
        instead of leaving its owner blocked on done.wait() forever."""
        while True:
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                return
            if req is not None:
                req.error = RuntimeError("PredictorService is closed")
                req.done.set()
                self._release([req])

    def _run_batch(self, batch: list[_Request]) -> None:
        """One merged predict_slides run over the union of the batch's
        paths; per-path results fan back out to every requester (duplicate
        paths across clients compute once)."""
        wanted: dict[str, list[_Request]] = {}
        for req in batch:
            for p in req.paths:
                wanted.setdefault(p, []).append(req)
        merged = list(wanted)

        failed_paths: set[str] = set()

        def on_error(path, e):
            msg = f"{type(e).__name__}: {e}"
            failed_paths.add(path)
            for req in wanted[path]:
                req.failed[path] = msg

        try:
            with self._lock:
                self.requests += len(batch)
            t0 = time.perf_counter()
            n_ok = 0
            for path, out in self.predictor.predict_slides(
                    merged, on_error=on_error):
                row = {g: _jsonable(v) for g, v in zip(self.genes, out[0])}
                n_ok += 1
                for req in wanted[path]:
                    req.results[path] = row
            dt = time.perf_counter() - t0
            with self._lock:
                self.slides_ok += n_ok
                self.slides_failed += len(failed_paths)
                if n_ok:
                    self.last_slide_seconds = round(dt / n_ok, 3)
        except BaseException as e:  # noqa: BLE001 — delivered per request
            for req in batch:
                if not req.done.is_set():
                    req.error = e
        finally:
            for req in batch:
                req.done.set()
            self._release(batch)

    def health(self) -> dict:
        p = self.predictor
        with self._lock:
            return {"status": "ok", "folds": len(p.vis_models),
                    "feat_type": p.extractor.feat_type,
                    "genes": len(self.genes),
                    "requests": self.requests,
                    "slides_ok": self.slides_ok,
                    "slides_failed": self.slides_failed,
                    "rejected": self.rejected,
                    "timed_out": self.timed_out,
                    "pending_slides": self._pending_slides,
                    "max_pending_slides": self.max_pending_slides,
                    "last_slide_seconds": self.last_slide_seconds}


class _Handler(BaseHTTPRequestHandler):
    service: PredictorService  # set by make_server

    def _reply(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # route to stderr-free quiet default
        pass

    def do_GET(self):
        if self.path == "/healthz":
            return self._reply(200, self.service.health())
        if self.path == "/genes":
            return self._reply(200, {"genes": self.service.genes,
                                     "n": len(self.service.genes)})
        return self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.path != "/predict":
            return self._reply(404, {"error": f"unknown path {self.path}"})
        try:
            n = int(self.headers.get("Content-Length", 0))
            if n < 0 or n > 1 << 20:  # paths, not payloads: 1 MiB is ample
                return self._reply(413, {"error": f"bad Content-Length {n}"})
            req = json.loads(self.rfile.read(n) or b"{}")
            wsi = req.get("wsi") if isinstance(req, dict) else None
            if isinstance(wsi, str):
                wsi = [wsi]
            if not wsi or not isinstance(wsi, list):
                return self._reply(
                    400, {"error": 'body must be {"wsi": path or [paths]}'})
        except (ValueError, json.JSONDecodeError) as e:
            return self._reply(400, {"error": f"bad request: {e}"})
        try:
            results, failed = self.service.predict([str(p) for p in wsi])
        except ServiceOverloaded as e:
            return self._reply(429, {"error": str(e)})
        except RequestTimeout as e:
            return self._reply(504, {"error": str(e)})
        except Exception as e:  # predictor bug: report, keep serving
            return self._reply(500, {"error": f"{type(e).__name__}: {e}"})
        self._reply(200 if results or not failed else 502,
                    {"predictions": results, "failed": failed})


def make_server(service: PredictorService, host: str = "127.0.0.1",
                port: int = 8000) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; ``.serve_forever()`` to run,
    ``.server_address`` for the bound (host, port) — port 0 picks a free
    one (used by tests)."""
    handler = type("Handler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def run(service: PredictorService, host: str, port: int) -> None:
    srv = make_server(service, host, port)
    h, p = srv.server_address[:2]
    print(f"serving on http://{h}:{p}  (POST /predict, GET /genes, "
          f"GET /healthz)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
