"""The port's HTTP serving (``sequoia_tpu_torch.http_serve``): a real port
predictor end to end on the CPU, and the service's merging, backpressure,
timeouts, serialization and shutdown with stand-in predictors, each of those
held on the JAX package's ``http_serve`` too (the same test on both
modules)."""

import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from sequoia_tpu import http_serve as jhttp
from sequoia_tpu_torch import http_serve as thttp
from sequoia_tpu_torch import native
from sequoia_tpu_torch.models import resnet, vis
from sequoia_tpu_torch.pipeline.features import FeatureExtractor
from sequoia_tpu_torch.serve import SlidePredictor
from tests.test_pipeline_e2e import synthetic_wsi

GENES = [f"G{i}" for i in range(5)]
BOTH = pytest.mark.parametrize("hs", [thttp, jhttp], ids=["port", "jax"])


def make_predictor(n_folds=2, n_clusters=8) -> SlidePredictor:
    extractor = FeatureExtractor("resnet", resnet.random_params(torch.Generator().manual_seed(0)),
                                 batch_size=16, patch_size=64, device="cpu")
    cfg = vis.ViSConfig(num_outputs=5, input_dim=2048, depth=1, nheads=2, dim_f=4, dim_s=4,
                        dim_c=4, num_clusters=n_clusters)
    models = [(cfg, vis.init(cfg, torch.Generator().manual_seed(i))) for i in range(n_folds)]
    return SlidePredictor(extractor, models, n_clusters=n_clusters, max_patches=48,
                          patch_size=64, device="cpu")


class _Server:
    """make_server on a free loopback port, served from a daemon thread."""

    def __init__(self, hs, service):
        self.srv = hs.make_server(service, port=0)
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        self.base = "http://127.0.0.1:%d" % self.srv.server_address[1]

    def get(self, path):
        with urllib.request.urlopen(self.base + path, timeout=30) as r:
            return json.loads(r.read())

    def post(self, obj, raw: bytes | None = None, timeout=300):
        req = urllib.request.Request(self.base + "/predict",
                                     data=raw if raw is not None else json.dumps(obj).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def test_http_serving_end_to_end(tmp_path):
    """/healthz, /genes and /predict on a slide file match the in-process
    predictor; a bad body gives 400 and an unreadable slide 502, and the
    server keeps serving; two concurrent POSTs both get the slide's row."""
    slide = synthetic_wsi(w=1024, h=768)
    wsi_path = str(tmp_path / "s1.tiff")
    native.write_tiled_tiff(wsi_path, slide.levels, tile=(128, 128))
    pred = make_predictor()
    direct = pred.predict_wsi(wsi_path)
    s = _Server(thttp, thttp.PredictorService(pred, GENES))
    try:
        h = s.get("/healthz")
        assert {k: h[k] for k in ("status", "folds", "feat_type", "genes")} == {
            "status": "ok", "folds": 2, "feat_type": "resnet", "genes": 5}
        assert h["requests"] == 0 and h["slides_ok"] == 0
        assert s.get("/genes") == {"genes": GENES, "n": 5}

        code, out = s.post({"wsi": wsi_path})
        assert code == 200 and list(out["predictions"]) == [wsi_path] and out["failed"] == {}
        np.testing.assert_allclose([out["predictions"][wsi_path][g] for g in GENES], direct[0],
                                   rtol=1e-5, atol=1e-6)
        code, out = s.post({"nope": 1})
        assert code == 400 and "error" in out
        code, out = s.post({"wsi": str(tmp_path / "missing.tiff")})
        assert code == 502 and out["predictions"] == {} and len(out["failed"]) == 1

        results = [None, None]

        def hit(i):
            results[i] = s.post({"wsi": wsi_path})

        ts = [threading.Thread(target=hit, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        for code, out in results:
            assert code == 200 and out["failed"] == {}
            np.testing.assert_allclose([out["predictions"][wsi_path][g] for g in GENES],
                                       direct[0], rtol=1e-5, atol=1e-6)
        h = s.get("/healthz")
        assert h["status"] == "ok" and h["slides_ok"] >= 2 and h["slides_failed"] == 1
        assert 3 <= h["requests"] <= 4  # the 400 never reached the predictor
        assert h["last_slide_seconds"] > 0
    finally:
        s.close()


def _fake_predictor(calls, per_slide=0.08, per_run=0.25):
    """predict_slides records each run's paths and sleeps per run and per
    slide; a path with "bad" in it fails through on_error."""

    class FakePredictor:
        vis_models = [None]

        class extractor:
            feat_type = "resnet"

        @staticmethod
        def predict_slides(paths, on_error=None):
            calls.append(tuple(paths))
            time.sleep(per_run)
            for p in paths:
                time.sleep(per_slide)
                if "bad" in p:
                    if on_error is None:
                        raise RuntimeError("boom")
                    on_error(p, RuntimeError("boom"))
                    continue
                yield p, np.asarray([[1.0, 2.0, 3.0]])

    return FakePredictor()


@BOTH
def test_concurrent_requests_merge_into_one_run(hs):
    calls: list[tuple] = []
    svc = hs.PredictorService(_fake_predictor(calls), ["A", "B", "C"])
    try:
        warm = threading.Thread(target=svc.predict, args=(["warm.svs"],))
        warm.start()
        time.sleep(0.1)  # the worker is inside the warm run
        outs: dict = {}

        def client(name, paths):
            outs[name] = svc.predict(paths)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(f"c{i}", [f"s{i}.svs"]))
                   for i in range(3)]
        threads.append(threading.Thread(target=client, args=("c3", ["s0.svs", "s3.svs"])))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        wall = time.perf_counter() - t0
        warm.join(timeout=60)
        assert len(calls) == 2, calls  # the warm run and one merged run
        assert sorted(calls[1]) == ["s0.svs", "s1.svs", "s2.svs", "s3.svs"]
        assert wall < 1.2, wall  # not four serial runs (>= 1.32 s)
        for i in range(3):
            assert outs[f"c{i}"][0] == {f"s{i}.svs": {"A": 1.0, "B": 2.0, "C": 3.0}}
        assert set(outs["c3"][0]) == {"s0.svs", "s3.svs"}
    finally:
        svc.close()


@BOTH
def test_merged_run_fans_out_failures(hs):
    calls: list[tuple] = []
    svc = hs.PredictorService(_fake_predictor(calls), ["A", "B", "C"])
    try:
        warm = threading.Thread(target=svc.predict, args=(["warm.svs"],))
        warm.start()
        time.sleep(0.1)
        outs: dict = {}

        def client(name, paths):
            outs[name] = svc.predict(paths)

        ts = [threading.Thread(target=client, args=("ok", ["fine.svs"])),
              threading.Thread(target=client, args=("bad", ["bad.svs"]))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        warm.join(timeout=60)
        assert outs["ok"][0]["fine.svs"]["A"] == 1.0 and not outs["ok"][1]
        assert not outs["bad"][0] and "boom" in outs["bad"][1]["bad.svs"]
        assert svc.slides_failed == 1 and svc.slides_ok >= 2
    finally:
        svc.close()


@BOTH
def test_backpressure_and_timeout(hs):
    """Past max_pending_slides a POST gets 429 at once; a client that gives
    up gets RequestTimeout and its queued slide is skipped; /healthz shows
    the pending count."""
    release, started = threading.Event(), threading.Event()
    served: list[str] = []

    class SlowPredictor:
        vis_models = [None]

        class extractor:
            feat_type = "resnet"

        @staticmethod
        def predict_slides(paths, on_error=None):
            started.set()
            release.wait(60)
            for p in paths:
                served.append(p)
                yield p, np.asarray([[1.0]])

    svc = hs.PredictorService(SlowPredictor(), ["A"], max_pending_slides=3)
    s = _Server(hs, svc)
    results: dict = {}
    try:
        ta = threading.Thread(target=lambda: results.update(a=s.post({"wsi": "s1"})),
                              daemon=True)
        ta.start()
        assert started.wait(30)
        tb = threading.Thread(target=lambda: results.update(b=s.post({"wsi": "s2"})),
                              daemon=True)
        tb.start()
        deadline = time.monotonic() + 30
        while svc.health()["pending_slides"] < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        with pytest.raises(hs.RequestTimeout):
            svc.predict(["s3"], timeout=0.2)
        code, out = s.post({"wsi": "s4"})
        assert code == 429 and "error" in out
        h = s.get("/healthz")
        assert h["pending_slides"] == 3 and h["max_pending_slides"] == 3
        assert h["rejected"] == 1 and h["timed_out"] == 1
        release.set()
        ta.join(30)
        tb.join(30)
        assert results["a"][0] == 200 and "s1" in results["a"][1]["predictions"]
        assert results["b"][0] == 200 and "s2" in results["b"][1]["predictions"]
        assert "s3" not in served
        deadline = time.monotonic() + 30
        while svc.health()["pending_slides"] != 0:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert svc.health()["slides_ok"] == 2
    finally:
        release.set()
        s.close()


@BOTH
def test_timeout_gives_504(hs):
    release = threading.Event()

    class Stalled:
        vis_models = [None]

        class extractor:
            feat_type = "resnet"

        @staticmethod
        def predict_slides(paths, on_error=None):
            release.wait(60)
            for p in paths:
                yield p, np.asarray([[1.0]])

    s = _Server(hs, hs.PredictorService(Stalled(), ["A"], request_timeout=0.2))
    try:
        code, out = s.post({"wsi": "x"})
        assert code == 504 and "0.2" in out["error"]
    finally:
        release.set()
        s.close()


@BOTH
def test_nan_serializes_as_null_and_bad_length(hs):
    class NaNPredictor:
        vis_models = [None]

        class extractor:
            feat_type = "resnet"

        @staticmethod
        def predict_slides(paths, on_error=None):
            for p in paths:
                yield p, np.asarray([[1.0, np.nan, np.inf]])

    s = _Server(hs, hs.PredictorService(NaNPredictor(), ["A", "B", "C"]))
    try:
        req = urllib.request.Request(s.base + "/predict", data=b'{"wsi": "x"}',
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            body = r.read().decode()
        assert "NaN" not in body and "Infinity" not in body
        assert json.loads(body)["predictions"]["x"] == {"A": 1.0, "B": None, "C": None}
        conn = http.client.HTTPConnection("127.0.0.1", s.srv.server_address[1], timeout=30)
        conn.putrequest("POST", "/predict")
        conn.putheader("Content-Length", "-1")
        conn.endheaders()
        assert conn.getresponse().status == 413
        conn.close()
        assert s.get("/healthz")["status"] == "ok"
    finally:
        s.close()
    assert thttp._jsonable(np.float32(2.5)) == 2.5 and thttp._jsonable(float("-inf")) is None


@BOTH
@pytest.mark.parametrize("body", ['["x.svs"]', '"x.svs"', "123", "null", "{bad json"])
def test_non_object_bodies_get_400(hs, body):
    s = _Server(hs, hs.PredictorService(_fake_predictor([]), ["A", "B", "C"]))
    try:
        code, out = s.post(None, raw=body.encode())
        assert code == 400 and "error" in out
        code, out = s.post(None, raw=b"{}")
        assert code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(s.base + "/nowhere", timeout=30)
        assert e.value.code == 404
    finally:
        s.close()


@BOTH
def test_shutdown_strands_no_request(hs):
    """close() lets the in-flight and the queued request finish, refuses
    later ones, is idempotent, and fails anything behind its sentinel."""
    svc = hs.PredictorService(_fake_predictor([]), ["A", "B", "C"])
    warm = threading.Thread(target=svc.predict, args=(["warm.svs"],))
    warm.start()
    time.sleep(0.1)
    outs: dict = {}
    t = threading.Thread(target=lambda: outs.update(q=svc.predict(["queued.svs"])))
    t.start()
    time.sleep(0.05)
    svc.close()
    t.join(timeout=60)
    warm.join(timeout=60)
    assert not t.is_alive() and outs["q"][0]["queued.svs"]["A"] == 1.0
    with pytest.raises(RuntimeError, match="closed"):
        svc.predict(["late.svs"])
    svc.close()
    svc2 = hs.PredictorService(_fake_predictor([]), ["A"])
    svc2.close()
    req = hs._Request(["ghost.svs"])
    svc2._pending.put(req)
    svc2._fail_remaining()
    assert req.done.is_set() and isinstance(req.error, RuntimeError)


@BOTH
def test_catastrophic_predictor_error_keeps_the_worker(hs):
    class Exploder:
        vis_models = [None]

        class extractor:
            feat_type = "resnet"

        calls = 0

        @classmethod
        def predict_slides(cls, paths, on_error=None):
            cls.calls += 1
            if cls.calls == 1:
                raise RuntimeError("catastrophic")
            for p in paths:
                yield p, np.asarray([[1.0, 2.0, 3.0]])

    svc = hs.PredictorService(Exploder(), ["A", "B", "C"])
    try:
        with pytest.raises(RuntimeError, match="catastrophic"):
            svc.predict(["x.svs"])
        ok, failed = svc.predict(["y.svs"])
        assert ok["y.svs"]["A"] == 1.0 and not failed
    finally:
        svc.close()
