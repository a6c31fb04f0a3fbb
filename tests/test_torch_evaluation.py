"""The evaluation modules of the port against the JAX package on the same
inputs (cases from tests/test_evaluation.py and tests/test_spatial_metrics.py):
the correlation statistics, ``evaluate_split_results`` (the constant-column
rule included), ``evaluate_model_dir`` and its CSVs, the EMD of spatial maps
and the GBM meta-modules; and the three CLIs (``evaluate_model``,
``get_emd``, ``gbm_analysis``) driven on both packages with the same argv,
``evaluate_model`` over the ``test_results.pkl`` the port's CV writes."""

import os
import pickle

import numpy as np
import pandas as pd
import pytest

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)

from sequoia_tpu.cli import evaluate_model as jcli_eval
from sequoia_tpu.cli import gbm_analysis as jcli_gbm
from sequoia_tpu.cli import get_emd as jcli_emd
from sequoia_tpu.evaluation import correlation_stats as jcs
from sequoia_tpu.evaluation import evaluate_model as jem
from sequoia_tpu.evaluation import gbm_modules as jgbm
from sequoia_tpu.evaluation import spatial_metrics as jsm
from sequoia_tpu_torch.cli import evaluate_model as tcli_eval
from sequoia_tpu_torch.cli import gbm_analysis as tcli_gbm
from sequoia_tpu_torch.cli import get_emd as tcli_emd
from sequoia_tpu_torch.evaluation import correlation_stats as tcs
from sequoia_tpu_torch.evaluation import evaluate_model as tem
from sequoia_tpu_torch.evaluation import gbm_modules as tgbm
from sequoia_tpu_torch.evaluation import spatial_metrics as tsm


def _same(got, want):
    """Equal results: arrays bit for bit (NaN where NaN), tuples by item."""
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_correlation_stats_match_jax():
    rng = np.random.default_rng(0)
    xy, xz, yz = (rng.uniform(-0.9, 0.9, 40) for _ in range(3))
    for name, args, kw in (
            ("fisher_z_ci", (xy, 103), {}),
            ("fisher_z_ci", (0.63, 50), {"conf_level": 0.9}),
            ("dependent_corr", (0.63, 0.31, 0.42, 103), {"twotailed": False}),
            ("dependent_corr", (xy, xz, yz, 60), {}),
            ("dependent_corr", (xy, xz, yz, 60), {"method": "zou"}),
            ("independent_corr", (0.5, 0.6, 103, 103), {}),
            ("independent_corr", (xy, xz, 60, 80), {"twotailed": False}),
            ("independent_corr", (xy, xz, 60), {"method": "zou"})):
        _same(getattr(tcs, name)(*args, **kw), getattr(jcs, name)(*args, **kw))
    for bad in (lambda m: m.dependent_corr(0.1, 0.2, 0.3, 10, method="x"),
                lambda m: m.independent_corr(0.1, 0.2, 10, method="x")):
        with pytest.raises(ValueError):
            bad(tcs)


def test_fdr_and_pearson_match_jax():
    rng = np.random.default_rng(1)
    p = rng.uniform(size=57)
    _same(tem.fdr_bh(p), jem.fdr_bh(p))
    x, y = rng.normal(size=(30, 6)), rng.normal(size=(30, 6))
    y[:, 0] = x[:, 0] * 2 + rng.normal(size=30) * 0.1
    y[:, 1] = 3.0  # a constant column: r NaN
    _same(tem.pearson_with_p(x, y), jem.pearson_with_p(x, y))


def _test_results(seed, folds=3, n=60, genes=10, const=True):
    """The sig-filter case of tests/test_evaluation.py; with ``const`` gene
    G9's real values are constant (r = 0, p = 1 by the reference's rule)."""
    rng = np.random.default_rng(seed)
    real = rng.normal(size=(n, genes)).astype(np.float32)
    pred = rng.normal(size=(n, genes)).astype(np.float32)
    rand = rng.normal(size=(n, genes)).astype(np.float32)
    pred[:, :4] = real[:, :4] + 0.2 * rng.normal(size=(n, 4))
    if const:
        real[:, genes - 1] = 1.5
    res = {"genes": [f"G{i}" for i in range(genes)]}
    for k, sl in enumerate(np.array_split(np.arange(n), folds)):
        res[f"split_{k}"] = {"real": real[sl], "preds": pred[sl], "random": rand[sl],
                             "wsi_file_name": [f"w{i}" for i in sl],
                             "tcga_project": ["TCGA-X"] * len(sl)}
    return res


@pytest.mark.parametrize("const", [False, True])
def test_evaluate_split_results_matches_jax(const):
    res = _test_results(2, const=const)
    got, want = tem.evaluate_split_results(res), jem.evaluate_split_results(res)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    pd.testing.assert_frame_equal(tem.significant_genes(got), jem.significant_genes(want))
    assert set(tem.significant_genes(got).index) == {"G0", "G1", "G2", "G3"}
    if const:
        assert tuple(got.loc["G9", ["pred_real_r", "pearson_p", "Steiger_p"]]) == (0, 1, 1)
    pd.testing.assert_frame_equal(tem.evaluate_split_results(res, folds=2),
                                  jem.evaluate_split_results(res, folds=2))


def _model_dir(root):
    os.makedirs(root / "brca")
    os.makedirs(root / "coad")
    os.makedirs(root / "luad")
    for cancer, seed, folds in (("brca", 3, 3), ("coad", 4, 5)):
        with open(root / cancer / "test_results.pkl", "wb") as f:
            pickle.dump(_test_results(seed, folds=folds), f)
    (root / "luad" / "test_results.pkl").write_bytes(b"not a pickle")


def _csvs(path):
    return {n: open(os.path.join(path, n)).read()
            for n in ("all_genes.csv", "sig_genes.csv", "num_sign_genes.csv")}


def test_evaluate_model_dir_and_cli_match_jax(tmp_path, capsys):
    _model_dir(tmp_path / "m")
    cancers = ["brca", "coad", "luad", "gbm"]
    got = tem.evaluate_model_dir(str(tmp_path / "m"), cancers, save_path=str(tmp_path / "t"))
    tout = capsys.readouterr().out
    want = jem.evaluate_model_dir(str(tmp_path / "m"), cancers, save_path=str(tmp_path / "j"))
    jout = capsys.readouterr().out
    for g, w in zip(got, want):
        pd.testing.assert_frame_equal(g, w)
    assert _csvs(tmp_path / "t") == _csvs(tmp_path / "j")
    assert tout == jout and "no data for luad (UnpicklingError" in tout
    assert "no data for gbm" in tout
    with pytest.raises(FileNotFoundError, match="no readable"):
        tem.evaluate_model_dir(str(tmp_path / "m"), ["gbm"], save_path=str(tmp_path / "x"))

    # the CLIs: same argv, same CSVs under {model_dir}/results
    argv = ["--model_dir", str(tmp_path / "m"), "--cancers", "brca", "coad", "--folds", "3"]
    jcli_eval.main(argv)
    jcsv = _csvs(tmp_path / "m" / "results")
    all_res, sig_res = tcli_eval.main(argv)
    assert _csvs(tmp_path / "m" / "results") == jcsv
    assert len(all_res) == 20 and set(sig_res["cancer"]) <= {"brca", "coad"}
    assert {a.dest for a in tcli_eval.build_parser()._actions} == \
        {a.dest for a in jcli_eval.build_parser()._actions}


def test_evaluate_model_reads_the_port_cv_results(tmp_path):
    """The port's ``train/cv.py`` writes the ``test_results.pkl`` the CLI
    evaluates, as the JAX CLI does."""
    from sequoia_tpu_torch.train import cv as tcv
    from tests.test_data_and_train import make_store

    df = make_store(str(tmp_path / "f"), n_slides=12, n_genes=5, dim=64, tokens=4)
    tcv.run_cross_validation(df, str(tmp_path / "f"), str(tmp_path / "m" / "syn"),
                             model_type="vis", depth=1, num_heads=1, k=3, batch_size=4,
                             num_epochs=1, seed=5, verbose=False, device="cpu")
    argv = ["--model_dir", str(tmp_path / "m"), "--cancers", "syn"]
    tall, _ = tcli_eval.main([*argv, "--save_path", str(tmp_path / "t")])
    jcli_eval.main([*argv, "--save_path", str(tmp_path / "j")])
    assert _csvs(tmp_path / "t") == _csvs(tmp_path / "j")
    assert len(tall) == 5 and list(tall.columns)[-1] == "cancer"


def _pred_map(seed, n=6, genes=("GENEA", "GENEB")):
    rng = np.random.default_rng(seed)
    pred = pd.DataFrame([(x, y) for x in range(n) for y in range(n)],
                        columns=["xcoord_tf", "ycoord_tf"])
    pred["xcoord"] = pred["xcoord_tf"] * 64
    pred["ycoord"] = pred["ycoord_tf"] * 64
    for g in genes:
        pred[g] = rng.random(len(pred))
    return pred, rng


def test_spatial_metrics_match_jax():
    a = np.zeros((5, 5))
    c = np.zeros((5, 5))
    a[1, 1], c[1, 4] = 1.0, 1.0
    for x, y, norm in ((a, a * 0, False), (a, c, False), (a, c, True), (a * 0, a * 0, False)):
        _same(tsm.calculate_emd(x, y, norm), jsm.calculate_emd(x, y, norm))
    gt = pd.DataFrame({"x": [0, 1, 10], "y": [0, 0, 0], "gene_expr": [1.0, 3.0, 100.0]})
    assert tsm.get_average(0, 0, gt, 2) == jsm.get_average(0, 0, gt, 2) == 2.0
    df = pd.DataFrame({"xcoord_tf": [0, 1, 2] * 3, "ycoord_tf": [0] * 3 + [1] * 3 + [2] * 3,
                       "v": [9.0, 1, 2, 3, 4, 5, 6, 7, 8]})
    for x, y in ((1, 1), (0, 0), (2, 1)):
        assert tsm.median_filter(df, "v", x, y, 1) == jsm.median_filter(df, "v", x, y, 1)
    _same(tsm.grid_from_df(df, "v"), jsm.grid_from_df(df, "v"))

    pred, rng = _pred_map(0)
    pred.loc[3, "GENEA"] = np.nan  # a border tile: dropped
    gt = pd.DataFrame({"x": pred["xcoord"] + rng.integers(-8, 8, len(pred)),
                       "y": pred["ycoord"] + rng.integers(-8, 8, len(pred)),
                       "gene_expr": rng.random(len(pred))})
    for num_tiles in (1, 4):
        got = tsm.emd_for_gene(pred, gt, "GENEA", num_tiles)
        assert got == jsm.emd_for_gene(pred, gt, "GENEA", num_tiles)
        assert np.isfinite(got["emd"]) and got["emd"] >= 0
    pd.testing.assert_frame_equal(tsm.attach_ground_truth(pred, gt),
                                  jsm.attach_ground_truth(pred, gt))


def _modules_df(seed=1, n=50):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({"xcoord_tf": np.arange(n) % 10, "ycoord_tf": np.arange(n) // 10})
    half = np.r_[np.ones(n // 2), np.zeros(n - n // 2)]
    df["a1"] = half * 10 + rng.random(n)
    df["a2"] = half * 8 + rng.random(n)
    df["b1"] = (1 - half) * 9 + rng.random(n)
    df["c1"] = rng.random(n)
    df.loc[7, "a2"] = np.nan  # a NaN tile, dropped listwise as in the reference
    return df


def test_gbm_modules_match_jax():
    df = _modules_df()
    modules = {"AC": ["a1", "a2", "missing_gene"], "MES1": ["b1"], "OPC": ["c1"], "G1S": []}
    assert tgbm.module_gene_columns(df, modules) == jgbm.module_gene_columns(df, modules)
    for method in ("pearson", "spearman"):
        pd.testing.assert_frame_equal(tgbm.correlation_matrix(df, modules, method),
                                      jgbm.correlation_matrix(df, modules, method))
    merged = tgbm.merge_categories(modules)
    assert merged == jgbm.merge_categories(modules)
    for mods in (modules, merged):
        pd.testing.assert_frame_equal(tgbm.percentile_scores(df, mods),
                                      jgbm.percentile_scores(df, mods))
        pd.testing.assert_series_equal(tgbm.assign_modules(df, mods),
                                       jgbm.assign_modules(df, mods))
    assert pd.isna(tgbm.assign_modules(df, modules)[7])
    corrs = [tgbm.correlation_matrix(_modules_df(s), modules) for s in (1, 2)]
    pd.testing.assert_frame_equal(tgbm.average_correlation(corrs),
                                  jgbm.average_correlation(corrs))


def test_get_emd_cli_matches_jax(tmp_path):
    pred, rng = _pred_map(3)
    pdir = tmp_path / "visualizations" / "spatial_GBM_pred" / "run1" / "HRI_7_T.tif"
    pdir.mkdir(parents=True)
    pred.to_csv(pdir / "stride-1.csv", index=False)
    for g in ("GENEA", "GENEB"):
        pd.DataFrame({"x": pred["xcoord"], "y": pred["ycoord"],
                      "gene_expr": pred[g] + 0.01 * rng.standard_normal(len(pred))}).to_csv(
            tmp_path / f"gt_{g}.csv", index=False)
    np.save(tmp_path / "genes.npy", np.asarray(["GENEA", "GENEB", "NOGENE"], dtype=object))
    template = str(tmp_path / "gt_{gene}.csv")
    for name, argv in (
            ("csv", ["--pred_csv", str(pdir / "stride-1.csv"), "--gene_names", "GENEA,GENEB",
                     "--gt_csv_template", template]),
            ("ref", ["--slide_nr", "7", "--pred_folder", "run1", "--data_root", str(tmp_path),
                     "--gene_names", str(tmp_path / "genes.npy"), "--gt_csv_template",
                     template])):
        outs = []
        for cli, side in ((jcli_emd, "jax"), (tcli_emd, "port")):
            cli.main([*argv, "--save_folder", f"{name}_{side}"] if name == "ref" else
                     [*argv, "--save_folder", str(tmp_path / f"{name}_{side}")])
            folder = (tmp_path / "visualizations" / "comparisons" / f"{name}_{side}" /
                      "HRI_7_T.tif") if name == "ref" else tmp_path / f"{name}_{side}"
            outs.append((folder / "metrics.csv").read_text())
        assert outs[1] == outs[0] and "GENEB" in outs[0]
    assert {a.dest for a in tcli_emd.build_parser()._actions} == \
        {a.dest for a in jcli_emd.build_parser()._actions}


def test_gbm_analysis_cli_matches_jax(tmp_path):
    csvs = []
    for s in (1, 2):
        path = tmp_path / f"slide{s}" / "stride-1.csv"
        path.parent.mkdir()
        _modules_df(s).to_csv(path, index=False)
        csvs.append(str(path))
    mod_dir = tmp_path / "modules"
    mod_dir.mkdir()
    np.save(mod_dir / "AC.npy", np.asarray(["a1", "a2"], dtype=object))
    np.save(mod_dir / "MES1.npy", np.asarray(["b1"], dtype=object))
    np.save(mod_dir / "OPC.npy", np.asarray(["c1"], dtype=object))
    for merged, slides in (("0", csvs), ("1", csvs[:1])):
        outs = {}
        for cli, side in ((jcli_gbm, "jax"), (tcli_gbm, "port")):
            out = tmp_path / f"{side}_{merged}"
            cli.main(["--pred_csv", *slides, "--module_dir", str(mod_dir), "--save_folder",
                      str(out), "--merged", merged, "--corr_method", "spearman"])
            outs[side] = {n: (out / n).read_text() for n in sorted(os.listdir(out))
                          if n.endswith(".csv")}
            pngs = {f"slide{s}_{kind}.png" for s in range(1, len(slides) + 1)
                    for kind in ("clustermap", "spatial")}
            assert {n for n in os.listdir(out) if n.endswith(".png")} == \
                pngs | ({"total_clustermap.png"} if len(slides) > 1 else set())
        assert outs["port"] == outs["jax"]
        assert ("total_corr.csv" in outs["port"]) == (len(slides) > 1)
    assert {a.dest for a in tcli_gbm.build_parser()._actions} == \
        {a.dest for a in jcli_gbm.build_parser()._actions}
