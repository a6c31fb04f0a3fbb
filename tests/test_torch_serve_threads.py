"""The port's streaming slide serving on the CPU: the thread cases of
tests/test_serve_and_ckpt.py (pipelined equals sequential, per-slide
quarantine, early cap, abandoned generator, consumer failure), none of
which may leave a decode thread running, and the screened mode."""

import threading
import time

import numpy as np
import pytest
import torch

from sequoia_tpu_torch.data.wsi import ArrayReader
from sequoia_tpu_torch.models import resnet, vis
from sequoia_tpu_torch.pipeline.features import FeatureExtractor
from sequoia_tpu_torch.serve import SlidePredictor
from tests.test_pipeline_e2e import synthetic_wsi

JOIN_S = 60


def make_predictor(n_folds=2, n_clusters=8):
    # one block per stage: the streaming cases need a backbone, not its depth
    params = resnet.random_params(torch.Generator().manual_seed(0))
    params.update({f"layer{s}": params[f"layer{s}"][:1] for s in range(1, 5)})
    ext = FeatureExtractor("resnet", params, batch_size=16, patch_size=64, device="cpu")
    cfg = vis.ViSConfig(num_outputs=5, input_dim=2048, depth=1, nheads=2, dim_f=4, dim_s=4,
                        dim_c=4, num_clusters=n_clusters)
    folds = [(cfg, vis.init(cfg, torch.Generator().manual_seed(i))) for i in range(n_folds)]
    return SlidePredictor(ext, folds, n_clusters=n_clusters, max_patches=48, patch_size=64,
                          device="cpu")


def slide(seed=0, appmag="20"):
    j = synthetic_wsi(seed=seed)
    return ArrayReader(j.levels, properties={"aperio.AppMag": appmag})


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Small CPU ops beside a decode thread, under parallel test workers:
    one intra-op thread keeps OpenMP's spinning workers from starving the
    other threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pred():
    return make_predictor()


def _tracking(pred):
    started = []
    orig = pred._start_producer

    def start(path, **kw):
        tup = orig(path, **kw)
        started.append(tup)
        return tup

    pred._start_producer = start
    return started


def _assert_joined(started):
    for tup in started:
        tup[1].join(timeout=JOIN_S)
        assert not tup[1].is_alive(), "decode thread stranded"


def test_predict_slides_pipelined_matches_predict_wsi(pred):
    slides = [slide(s) for s in (0, 1)]
    want = [pred.predict_wsi(s) for s in slides]
    got = list(pred.predict_slides(slides))
    assert [id(p) for p, _ in got] == [id(s) for s in slides]
    for (_, g), w in zip(got, want):
        assert g.shape == (1, 5) and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_predict_wsi_equals_screened_patches(pred):
    """The fused screen + featurise stream keeps the same patches as the
    screened extraction and gives the same prediction."""
    s = slide(2)
    np.testing.assert_allclose(pred.predict_wsi(s),
                               pred.predict_patches(pred.extract_patches(s)),
                               rtol=1e-5, atol=1e-5)


def test_screened_mode_resizes_and_caps():
    """AppMag 40: candidates read at 128 px are screened, resized to 64 and
    capped at max_patches; the stream equals the sequential extraction."""
    p = make_predictor()
    s = slide(1, appmag="40")
    started = _tracking(p)
    streamed = p.predict_wsi(s)
    assert started[0][4] == "screened" and started[0][5] == 2.0
    patches = p.extract_patches(s)
    assert patches.shape[1:] == (64, 64, 3) and 0 < len(patches) <= 48
    np.testing.assert_allclose(streamed, p.predict_patches(patches), rtol=1e-5, atol=1e-5)
    _assert_joined(started)


def test_predict_slides_quarantine_and_no_stranded_threads(pred):
    good = [slide(0), slide(1)]
    n0 = threading.active_count()
    failures = []
    got = list(pred.predict_slides([good[0], "/nonexistent/slide.svs", good[1]],
                                   on_error=lambda p, e: failures.append(p)))
    assert [id(p) for p, _ in got] == [id(g) for g in good]
    assert failures == ["/nonexistent/slide.svs"]
    assert threading.active_count() == n0
    # without on_error the failure propagates and the lookahead joins too
    with pytest.raises(Exception):
        list(pred.predict_slides(["/nonexistent/slide.svs", good[0]]))
    assert threading.active_count() == n0


def test_predict_slides_raising_on_error_reaps_lookahead():
    p = make_predictor()
    started = _tracking(p)

    def bad_on_error(path, exc):
        raise RuntimeError("logging bug in the quarantine callback")

    with pytest.raises(RuntimeError, match="logging bug"):
        list(p.predict_slides(["/nonexistent/slide.svs", slide(0)], on_error=bad_on_error))
    assert len(started) == 2  # slide 1 + the prefetched slide 2
    _assert_joined(started)


def test_predict_wsi_early_cap_with_slow_producer_terminates():
    """The cap is reached while the producer is mid-chunk with the queue
    empty: the consumer must not block on q.get()."""
    p = make_predictor()  # max_patches=48, batch 16
    rng = np.random.default_rng(0)

    def tissue_chunk(n):
        c = np.empty((n, 64, 64, 3), np.uint8)
        c[..., 0] = rng.integers(150, 220, c.shape[:3])
        c[..., 1] = rng.integers(60, 140, c.shape[:3])
        c[..., 2] = rng.integers(150, 230, c.shape[:3])
        return c

    def slow_chunks(candidates, decode_chunk=64, stop=None):
        yield tissue_chunk(64)  # more than max_patches of tissue
        time.sleep(2.0)  # the consumer hits the cap meanwhile
        yield tissue_chunk(64)

    p._decode_chunks = slow_chunks
    started = _tracking(p)
    result = []
    worker = threading.Thread(target=lambda: result.append(p.predict_wsi(slide(0))),
                              daemon=True)
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive(), "predict_wsi deadlocked after early cap"
    assert result and result[0].shape == (1, 5) and np.isfinite(result[0]).all()
    assert p.io_stats["kept"] == 48
    _assert_joined(started)


def test_early_cap_stops_decoding():
    """Decoding ends once max_patches are kept: fewer chunks are decoded
    than the slide has."""
    p = make_predictor()
    decoded = []
    orig = p._decode_chunks

    def counting(candidates, decode_chunk=64, stop=None):
        for chunk in orig(candidates, 16, stop):
            decoded.append(len(chunk))
            yield chunk

    p._decode_chunks = counting
    n_cands = len(p._candidates(slide(0))[1])
    p.predict_wsi(slide(0))
    assert p.io_stats["kept"] == 48
    assert sum(decoded) < n_cands


def test_predict_slides_abandoned_generator_reaps_lookahead():
    p = make_predictor()
    started = _tracking(p)
    for _path, out in p.predict_slides([slide(0), slide(1), slide(2)]):
        assert np.isfinite(out).all()
        break  # abandon with the slide-2 lookahead running
    assert len(started) == 2  # slide 1 + the prefetched slide 2
    _assert_joined(started)


def test_predict_wsi_consumer_failure_does_not_strand_producer():
    p = make_predictor()

    class Boom(RuntimeError):
        pass

    def boom(*a, **k):
        raise Boom("backbone OOM")

    class FailingExtractor:
        batch_size = 8
        feature_dim = p.extractor.feature_dim
        params = None
        raw_fwd = staticmethod(boom)
        upload = staticmethod(torch.as_tensor)

    p.extractor = FailingExtractor()
    n0 = threading.active_count()
    with pytest.raises(Boom):
        p.predict_wsi(slide(0))
    assert threading.active_count() == n0


def test_no_tissue_raises(pred):
    blank = ArrayReader([np.full((512, 512, 3), 242, np.uint8),
                         np.full((128, 128, 3), 242, np.uint8)],
                        properties={"aperio.AppMag": "20"})
    with pytest.raises(ValueError, match="no tissue"):
        pred.predict_wsi(blank)


def test_iter_raw_chunks_are_the_unscreened_candidates(pred):
    s = slide(0)
    _, coords, psr, _ = pred._candidates(s)
    chunks = list(pred.iter_raw_chunks(s, decode_chunk=100))
    assert [len(c) for c in chunks[:-1]] == [100] * (len(chunks) - 1)
    raw = np.concatenate(chunks)
    assert raw.shape == (len(coords), psr, psr, 3)
    x, y = coords[5]
    np.testing.assert_array_equal(raw[5], s.read_region((x, y), 0, (psr, psr)))
    stop = threading.Event()
    stop.set()
    assert list(pred.iter_raw_chunks(s, stop=stop)) == []
    with pytest.raises(ValueError, match="AppMag 20"):
        list(pred.iter_raw_chunks(slide(0, appmag="40")))
