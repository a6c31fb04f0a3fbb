"""The port's serve CLI (``sequoia_tpu_torch.cli.serve``) against the JAX
package's on the same fabricated checkpoints and slide files: the same CSV
header and rows, values within rtol 1e-3 / atol 1e-4, with both packages'
clustering on the host ``hybrid`` k-means from one seed (as
tests/test_torch_serve_wsi.py shares it), then the CLI's checks and exits."""

import csv
import os
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sequoia_tpu.cli import serve as jcli
from sequoia_tpu.ops import kmeans as jkm
from sequoia_tpu.serve import SlidePredictor as JPredictor
from sequoia_tpu_torch import native
from sequoia_tpu_torch.cli import serve as tcli
from sequoia_tpu_torch.models import vis
from sequoia_tpu_torch.ops import kmeans as tkm
from sequoia_tpu_torch.serve import SlidePredictor
from sequoia_tpu_torch.train import checkpoint
from tests.test_pipeline_e2e import synthetic_wsi
from tests.torch_goldens import make_torch_sd, resnet50_sd, vis_shapes

K, PS, BATCH, CAP = 8, 64, 16, 48
GENES = [f"G{i}" for i in range(5)]
COMMON = ["--batch_size", str(BATCH), "--compute_dtype", "float32", "--max_patches", str(CAP),
          "--patch_size", str(PS), "--num_clusters", str(K)]


def _fold_sd(seed: int, d: int = 2048) -> dict[str, np.ndarray]:
    sd = make_torch_sd(torch.Generator().manual_seed(seed),
                       vis_shapes(len(GENES), d, 1, 2, 4, 4, 4, K))
    return {k: v.float().numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """ResNet weights, a 2-fold CV dir with test_results.pkl, fold 0 as an HF
    dir, a tiled TIFF written by the port's reader and a flat PNG."""
    from PIL import Image

    root = tmp_path_factory.mktemp("serve_cli")
    rsd = resnet50_sd(torch.Generator().manual_seed(0))
    checkpoint.save_torch_state_dict({k: v.float().numpy() for k, v in rsd.items()},
                                     str(root / "resnet50.pt"))
    exp = root / "exp"
    for i in range(2):
        checkpoint.save_torch_state_dict(_fold_sd(10 + i), str(exp / f"model_best_{i}.pt"))
    with open(exp / "test_results.pkl", "wb") as f:
        pickle.dump({"genes": GENES}, f)
    hf = root / "hf"
    os.makedirs(hf)
    checkpoint._write_hf_dir(str(hf), {}, _fold_sd(10))
    slide = synthetic_wsi(w=1024, h=768)
    native.write_tiled_tiff(str(root / "slide1.tiff"), slide.levels, tile=(128, 128))
    Image.fromarray(synthetic_wsi(w=512, h=384, seed=3).levels[0]).save(root / "slide2.png")
    return root


def _shared_clustering(monkeypatch):
    """Both packages' SlidePredictor.cluster on the host hybrid k-means
    from seed 0 (their device k-means draw different streams)."""
    def jcluster(self, feats):
        cf = jkm.kmeans_cluster_features(np.asarray(feats), self.n_clusters, seed=0,
                                         backend="hybrid")
        return jnp.asarray(np.nan_to_num(cf))

    def tcluster(self, feats):
        cf = tkm.kmeans_cluster_features(feats.cpu().numpy(), self.n_clusters, seed=0,
                                         backend="hybrid", device="cpu")
        return torch.as_tensor(np.nan_to_num(cf))

    monkeypatch.setattr(JPredictor, "cluster", jcluster)
    monkeypatch.setattr(SlidePredictor, "cluster", tcluster)


def _read(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], np.asarray([[float(v) for v in r[1:]]
                                                          for r in rows[1:]])


def _both(files, monkeypatch, ckpt, *extra, jax_too=True, common=COMMON):
    """Run the port's CLI (and the JAX CLI) on the two slides -> (port CSV,
    JAX CSV or None) as (header, names, values)."""
    monkeypatch.chdir(files)
    _shared_clustering(monkeypatch)
    args = ["--wsi", "slide1.tiff", "slide2.png", "--checkpoints", str(files / ckpt),
            "--weights", "resnet50.pt", *common, *extra]
    if jax_too:
        jcli.main([*args, "--out", "jax.csv"])
    got = tcli.main([*args, "--device", "cpu", "--out", "port.csv"])
    assert got["slides"] == 2 and got["failed"] == 0
    return _read("port.csv"), _read("jax.csv") if jax_too else None


def _assert_same_csv(port, jax_):
    assert port[0] == jax_[0]
    assert port[1] == jax_[1] == ["slide1.tiff", "slide2.png"]
    assert port[2].shape == jax_[2].shape and np.isfinite(port[2]).all()
    np.testing.assert_allclose(port[2], jax_[2], rtol=1e-3, atol=1e-4)


def test_cli_matches_jax_from_pt_folds(files, monkeypatch):
    port, jax_ = _both(files, monkeypatch, "exp")
    assert port[0] == ["wsi_file_name", *GENES]  # gene names from test_results.pkl
    _assert_same_csv(port, jax_)
    # --panel serves the same values as the full head's columns (the JAX
    # CLI's panel run is held in the HF-dir test)
    panel, _ = _both(files, monkeypatch, "exp", "--panel", "G3,G1", jax_too=False)
    assert panel[0] == ["wsi_file_name", "G3", "G1"] and panel[1] == port[1]
    np.testing.assert_allclose(panel[2], port[2][:, [3, 1]], rtol=1e-5, atol=1e-6)


def test_cli_default_dtype_matches_jax(files, monkeypatch):
    """At the default ``--compute_dtype`` (bfloat16) the port serves the ViS
    folds in bf16 and the JAX CLI in f32 (it passes the flag to the
    extractor only).  The two CSVs stay within the f32 runs' rtol, and each
    slide's gene profile keeps a Pearson r with JAX's within the parity
    budget, 1 - r <= 1e-3 (docs/PARITY_NOTES.md:4-5; two slides give no
    per-gene r across slides)."""
    common = [c for c in COMMON if c not in ("--compute_dtype", "float32")]
    assert tcli.build_parser().parse_args(["--checkpoints", "x", "--weights", "random"]) \
        .compute_dtype == "bfloat16"
    port, jax_ = _both(files, monkeypatch, "exp", common=common)
    _assert_same_csv(port, jax_)
    for a, b in zip(port[2], jax_[2]):
        assert 1.0 - np.corrcoef(a, b)[0, 1] <= 1e-3


def test_cli_matches_jax_from_hf_dir_with_panel(files, monkeypatch):
    port, jax_ = _both(files, monkeypatch, "hf", "--panel", "gene_4,gene_0")
    assert port[0] == ["wsi_file_name", "gene_4", "gene_0"]
    _assert_same_csv(port, jax_)


def test_load_fold_models_layouts(files):
    pt = tcli.load_fold_models(str(files / "exp"))
    hf = tcli.load_fold_models(str(files / "hf"))
    one = tcli.load_fold_models(str(files / "exp" / "model_best_1.pt"))
    assert len(pt) == 2 and len(hf) == len(one) == 1
    for k in ("head_w", "pos_emb"):
        assert torch.equal(pt[0][1][k], hf[0][1][k])
        assert torch.equal(pt[1][1][k], one[0][1][k])
    assert pt[0][0] == hf[0][0] and pt[0][0].num_clusters == K
    with pytest.raises(SystemExit, match="vis-only"):
        tcli.load_fold_models(str(files / "hf"), model_type="vit")
    with pytest.raises(SystemExit, match="model_best"):
        tcli.load_fold_models(str(files))


@pytest.mark.parametrize("ext", [".csv", ".npy", ".txt"])
def test_gene_list_files_read_as_in_jax(tmp_path, ext):
    path = str(tmp_path / f"genes{ext}")
    if ext == ".csv":
        with open(path, "w") as f:
            f.write("idx,gene\n0,TP53\n1,EGFR\n2,\"A,B\"\n")
    elif ext == ".npy":
        np.save(path, np.asarray(["TP53", "EGFR"], dtype=object), allow_pickle=True)
    else:
        with open(path, "w") as f:
            f.write("TP53\n\nEGFR\n")
    assert tcli.read_gene_list_file(path) == jcli.read_gene_list_file(path)
    assert tcli._gene_list_arg(path, "--panel") == jcli._gene_list_arg(path, "--panel")


def test_gene_names_and_panel(files):
    assert tcli.load_gene_names(None, str(files / "exp"), 5) == GENES
    assert tcli.load_gene_names(None, str(files / "hf"), 3) == ["gene_0", "gene_1", "gene_2"]
    assert tcli.load_gene_names("A,B", str(files / "exp"), 2) == ["A", "B"]
    assert tcli.resolve_panel("G3,G1", GENES) == ([3, 1], ["G3", "G1"])
    with pytest.raises(SystemExit, match="not in the model's gene list"):
        tcli.resolve_panel("NOPE", GENES)
    with pytest.raises(SystemExit, match="not found"):
        tcli.resolve_panel("missing.csv", GENES)


def _port(files, monkeypatch, *args):
    monkeypatch.chdir(files)
    return tcli.main(["--checkpoints", str(files / "exp"), "--weights", "random", *COMMON,
                      "--device", "cpu", *args])


def test_cli_config_mismatches_exit(files, monkeypatch, tmp_path):
    with pytest.raises(SystemExit, match="gene names vs model head"):
        _port(files, monkeypatch, "--wsi", "slide1.tiff", "--gene_names", "A,B,C")
    with pytest.raises(SystemExit, match="num_clusters"):
        _port(files, monkeypatch, "--wsi", "slide1.tiff", "--num_clusters", "100")
    small = tmp_path / "small"
    checkpoint.save_torch_state_dict(_fold_sd(3, d=16), str(small / "model_best_0.pt"))
    with pytest.raises(SystemExit, match="input_dim 16"):
        tcli.main(["--wsi", str(files / "slide1.tiff"), "--checkpoints", str(small),
                   "--weights", "random", *COMMON, "--device", "cpu"])
    with pytest.raises(SystemExit, match="need --wsi"):
        _port(files, monkeypatch)
    with pytest.raises(SystemExit, match="mutually exclusive"):
        _port(files, monkeypatch, "--wsi", "slide1.tiff", "--http", "8000")
    with pytest.raises(SystemExit, match=r"\[HOST:\]PORT"):
        _port(files, monkeypatch, "--http", "localhost:http")


def test_cli_duplicates_quarantine_and_all_failed(files, monkeypatch, capsys):
    out = _port(files, monkeypatch, "--wsi", "slide1.tiff", "slide1.tiff", "--out", "dup.csv")
    assert out["slides"] == 1 and len(_read("dup.csv")[1]) == 1
    assert "duplicate" in capsys.readouterr().err
    # one unreadable slide is quarantined; the others are written
    out = _port(files, monkeypatch, "--wsi", "missing.tiff", "slide1.tiff", "--out", "q.csv")
    assert out == {"slides": 1, "failed": 1, "serve_seconds": out["serve_seconds"],
                   "out": "q.csv"}
    assert _read("q.csv")[1] == ["slide1.tiff"]
    assert "missing.tiff" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="all 1 slides failed"):
        _port(files, monkeypatch, "--wsi", "missing.tiff", "--out", "none.csv")
    assert not (files / "none.csv").exists()


def test_cli_profile_writes_trace(files, monkeypatch, tmp_path):
    _port(files, monkeypatch, "--wsi", "slide1.tiff", "--profile", str(tmp_path / "tr"),
          "--out", "p.csv")
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("flag", [["--data_parallel"], ["--multihost"],
                                  ["--feat_type", "uni", "--model_type", "vit",
                                   "--data_parallel"],
                                  ["--model_type", "vit", "--multihost"],
                                  ["--model_type", "he2rna", "--data_parallel"]])
def test_unported_flags_stop_at_parse_time(flag):
    """The multi-GPU flags, which once stopped at parse time, now parse with
    every model type, as the JAX CLI's do (they run in
    tests/test_torch_dp_extraction.py and tests/test_torch_fleet_cli.py)."""
    argv = ["--checkpoints", "x", "--weights", "random", *flag]
    args, jargs = tcli.build_parser().parse_args(argv), jcli.build_parser().parse_args(argv)
    for dest in ("data_parallel", "multihost", "model_type", "feat_type"):
        assert getattr(args, dest) == getattr(jargs, dest)
    assert args.data_parallel == ("--data_parallel" in flag)
    assert args.multihost == ("--multihost" in flag)


def test_cli_needs_cuda_unless_asked_for_cpu(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(files)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--wsi", "slide1.tiff", "--checkpoints", str(files / "exp"),
                   "--weights", "random", *COMMON])


def test_serving_kernel_set():
    """On CUDA the serving set is K4, K5 and K1; K1 is left out, with the
    reason, for a fold config outside its packed layout (UNI's reference
    ViS: input_dim 1024 against 2P = 2048), and takes any head width (8 x
    96); other devices get none."""
    cfg = vis.ViSConfig(num_outputs=5, input_dim=2048, nheads=16, dim_f=64, dim_s=64,
                        dim_c=64, compute_dtype="bfloat16")
    odd = vis.ViSConfig(num_outputs=5, input_dim=1024, nheads=16, dim_f=64, dim_s=64,
                        dim_c=64, compute_dtype="bfloat16")
    wide = vis.ViSConfig(num_outputs=5, input_dim=1536, nheads=8, dim_f=96, dim_s=96,
                         dim_c=96, compute_dtype="bfloat16")
    assert tcli.serving_kernels("cuda", [(cfg, None)]) == (list(tcli.SERVING_KERNELS), "")
    assert tcli.serving_kernels("cuda", [(wide, None)]) == (list(tcli.SERVING_KERNELS), "")
    on, why = tcli.serving_kernels("cuda", [(cfg, None), (odd, None)])
    assert on == ["bottleneck_chain", "lloyd_stats"] and "packed layout" in why
    assert tcli.serving_kernels("cpu", [(cfg, None)]) == ([], "")
    assert tcli.serving_kernels("cuda", [(cfg, None)], ("lloyd_stats",)) == (
        ["lloyd_stats"], "")
    with pytest.raises(ValueError, match="not serving kernels"):
        tcli.serving_kernels("cuda", [(cfg, None)], ("stem16",))
    pred, line = tcli.build_predictor("resnet", "random", [(cfg, vis.init(
        cfg, torch.Generator().manual_seed(0)))], device="cpu", batch_size=4)
    assert not pred.use_pallas and pred._packed is None
    assert pred.extractor.cfg.fused_stages == () and "none (plain PyTorch)" in line


def test_load_extractor(files):
    """A torchvision state dict loads through ``resnet50_from_torch`` (as in
    JAX), ``random`` draws seed 0, the kernel options reach the config, and
    ``data_parallel`` gives a mesh over this process's devices (one CPU)."""
    from sequoia_tpu_torch.cli.compute_features import load_extractor
    from sequoia_tpu_torch.models import resnet

    ext = load_extractor("resnet", str(files / "resnet50.pt"), 8, "bfloat16", device="cpu",
                         fused_stages=(1, 2))
    want = resnet.resnet50_from_torch(checkpoint.load_torch_checkpoint(
        str(files / "resnet50.pt")))
    assert torch.equal(ext.params["layer2"][1]["conv2"], want["layer2"][1]["conv2"])
    assert ext.cfg.fused_stages == (1, 2) and ext.cfg.compute_dtype == torch.bfloat16
    assert ext.batch_size == 8 and ext.device.type == "cpu" and ext.feature_dim == 2048
    rnd = load_extractor("resnet", "random", 4, device="cpu")
    assert torch.equal(rnd.params["conv1"], resnet.random_params(
        torch.Generator().manual_seed(0))["conv1"])
    with pytest.raises(ValueError, match="ResNet option"):
        load_extractor("uni", "random", 4, device="cpu", fused_stages=(1,))
    dp = load_extractor("resnet", "random", 4, data_parallel=True, device="cpu")
    assert dp.mesh.shape == {"data": 1, "model": 1} and dp.device.type == "cpu"
    assert torch.equal(dp.params["conv1"], rnd.params["conv1"])


def test_stage_timer_and_trace(tmp_path):
    """``utils/profiling``: the JAX StageTimer's accounting, and a
    ``torch.profiler`` trace (a no-op without a directory)."""
    from sequoia_tpu.utils.profiling import StageTimer as JTimer
    from sequoia_tpu_torch.utils.profiling import StageTimer, device_trace

    for timer in (StageTimer(), JTimer()):
        with timer.stage("decode", items=4):
            pass
        with timer.stage("decode", items=2):
            pass
        with timer.stage("features", items=6):
            torch.ones(4).sum()
        assert timer.stages["decode"]["items"] == 6 and timer.rate("missing") == 0.0
        assert timer.slides_per_hour() > 0 and "decode" in timer.report()
    with device_trace(None):
        pass
    with device_trace(str(tmp_path / "t")):
        torch.ones(8).cumsum(0)
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0


def test_bench_serving_smoke(capsys):
    """The port's serving microbench prints one JSON line with both legs."""
    import json

    from sequoia_tpu_torch import bench_serving

    out = bench_serving.main(["--device", "cpu", "--kernels", "off", "--genes", "64",
                              "--panel", "8", "--reps", "2", "--input_dim", "32",
                              "--folds", "2", "--depth", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out and out["kernels"] == "none" and out["folds"] == 2
    assert out["full_head"]["genes"] == 64 and out["panel"]["genes"] == 8
    assert out["full_head"]["ms"] > 0 and out["panel"]["ms"] > 0
