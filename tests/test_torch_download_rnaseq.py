"""The port's GDC RNA-seq downloader (``sequoia_tpu_torch/cli/
download_rnaseq.py``) against the JAX package's, both run against
tests/test_gdc_protocol.py's local emulation of the GDC REST API (no
network): the same requests and equal tables, and the offline message when
the server is gone."""

import pandas as pd
import pytest

from sequoia_tpu.cli import download_rnaseq as jdl
from sequoia_tpu_torch.cli import download_rnaseq as dl
from tests.test_gdc_protocol import FakeGDC, gdc_server  # noqa: F401  (the fixture)


def _run(mod, url, out, monkeypatch, argv=()):
    monkeypatch.setattr(mod, "GDC", url)
    FakeGDC.requests_seen = []
    mod.main(["--projects", "TCGA-TEST", "TCGA-TWO", "--out", str(out), *argv])
    return list(FakeGDC.requests_seen)


@pytest.mark.parametrize("argv", [(), ("--max_samples", "2")])
def test_tables_equal_jax(gdc_server, tmp_path, monkeypatch, capsys, argv):  # noqa: F811
    jreq = _run(jdl, gdc_server, tmp_path / "jax", monkeypatch, argv)
    treq = _run(dl, gdc_server, tmp_path / "torch", monkeypatch, argv)
    assert treq == jreq and len(treq) == 2 * (1 + (2 if argv else 3))
    out = capsys.readouterr().out
    assert out.count("wrote") == 4 and "failed" not in out
    for project in ("TCGA-TEST", "TCGA-TWO"):
        want = pd.read_csv(tmp_path / "jax" / f"{project}_fpkm_uq.csv", index_col=0)
        got = pd.read_csv(tmp_path / "torch" / f"{project}_fpkm_uq.csv", index_col=0)
        pd.testing.assert_frame_equal(got, want)
        assert set(got.index) == {"TP53", "MIR21"}
        assert list(got.columns) == [f"{project}-S{i}" for i in range(2 if argv else 3)]


def test_offline_reports_failure(tmp_path, monkeypatch, capsys):
    # a local port nothing listens on: the request is refused
    monkeypatch.setattr(dl, "GDC", "http://127.0.0.1:9")
    dl.main(["--projects", "TCGA-TEST", "--out", str(tmp_path)])
    assert "download failed" in capsys.readouterr().out
    assert not (tmp_path / "TCGA-TEST_fpkm_uq.csv").exists()
