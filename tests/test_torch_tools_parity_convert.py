"""The port's ``tools/parity_check.py`` and ``tools/convert_weights.py``
(``sequoia_tpu_torch/tools/``) against the JAX package's tools of those names
on the same inputs: the same report and exit code; the same ``.pt`` from an
HF directory; ``.pt`` -> DCP -> ``.pt`` bit for bit."""

import json
import pickle

import numpy as np
import pytest
import torch

import jax

from sequoia_tpu.models import convert as jconvert
from sequoia_tpu.models import he2rna as jhe2rna
from sequoia_tpu.models import vis as jvis
from sequoia_tpu.models import vit as jvit
from sequoia_tpu_torch.tools import convert_weights as tcw
from sequoia_tpu_torch.tools import parity_check as tpc
from sequoia_tpu_torch.train import checkpoint
from tools import convert_weights as jcw
from tools import parity_check as jpc


def _results(path, real, pred, wsis, genes, order, folds=2):
    """A ``test_results.pkl`` with the slides in ``order`` split over folds."""
    parts = np.array_split(order, folds)
    res = {"genes": genes}
    for i, idx in enumerate(parts):
        res[f"split_{i}"] = {"real": real[idx], "preds": pred[idx], "random": pred[idx],
                             "wsi_file_name": wsis[idx], "tcga_project": ["X"] * len(idx)}
    with open(path, "wb") as f:
        pickle.dump(res, f)


@pytest.fixture
def pickles(tmp_path):
    rng = np.random.default_rng(0)
    n, genes = 24, [f"G{i}" for i in range(12)]
    real = rng.normal(size=(n, len(genes))).astype(np.float32)
    pred = real + 0.3 * rng.normal(size=real.shape).astype(np.float32)
    wsis = np.asarray([f"w{i:02d}" for i in range(n)])
    _results(tmp_path / "ref.pkl", real, pred, wsis, genes, np.arange(n))
    # the same predictions in another slide order and split: passes
    _results(tmp_path / "same.pkl", real, pred + 1e-7, wsis, genes, rng.permutation(n), 3)
    # perturbed predictions: fails
    _results(tmp_path / "bad.pkl", real, pred + 0.3 * rng.normal(size=pred.shape)
             .astype(np.float32), wsis, genes, np.arange(n))
    return tmp_path


@pytest.mark.parametrize("ours,rc", [("same.pkl", 0), ("bad.pkl", 1)])
def test_parity_check_same_report_and_exit_code(pickles, capsys, ours, rc):
    argv = ["--ref", str(pickles / "ref.pkl"), "--ours", str(pickles / ours)]
    want_rc = jpc.main(argv)
    want = capsys.readouterr().out
    got_rc = tpc.main(argv)
    assert got_rc == want_rc == rc
    assert capsys.readouterr().out == want
    assert ("PASS" if rc == 0 else "FAIL") in want


def test_parity_check_tolerance_option(pickles, capsys):
    argv = ["--ref", str(pickles / "ref.pkl"), "--ours", str(pickles / "bad.pkl"),
            "--tol", "2.0"]
    assert tpc.main(argv) == jpc.main(argv) == 0


def test_parity_check_refuses_other_cohorts(pickles, tmp_path):
    with open(pickles / "ref.pkl", "rb") as f:
        res = pickle.load(f)
    res["split_0"]["wsi_file_name"] = np.asarray(
        ["other"] * len(res["split_0"]["wsi_file_name"]))
    with open(tmp_path / "other.pkl", "wb") as f:
        pickle.dump(res, f)
    with pytest.raises(ValueError, match="cohorts differ"):
        tpc.main(["--ref", str(pickles / "ref.pkl"), "--ours", str(tmp_path / "other.pkl")])


# ---------------------------------------------------------------------------
# convert_weights

def _vis_jax():
    cfg = jvis.ViSConfig(num_outputs=6, input_dim=16, depth=2, nheads=2, dim_f=4, dim_s=4,
                         dim_c=4, num_clusters=5)
    return cfg, jvis.init(cfg, jax.random.PRNGKey(0))


def _torch_sd(model: str) -> dict:
    """A reference state dict of ``model`` from JAX-initialised weights."""
    if model == "vis":
        cfg, params = _vis_jax()
        return jconvert.vis_to_torch(cfg, params)
    if model == "vit":
        cfg = jvit.ViTConfig(num_outputs=6, dim=64, depth=1, heads=2, dim_head=64,
                             mlp_dim=16, num_clusters=5)
        return jconvert.vit_to_torch(cfg, jvit.init(cfg, jax.random.PRNGKey(1)))
    cfg = jhe2rna.HE2RNAConfig(input_dim=16, output_dim=6, layers=(8, 8), ks=(1, 2, 5))
    return jconvert.he2rna_to_torch(cfg, jhe2rna.init(cfg, jax.random.PRNGKey(2)))


def _assert_sd_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_convert_hf_dir_to_pt_equals_jax_tool(tmp_path):
    hf = tmp_path / "sequoia-test-0"
    hf.mkdir()
    torch.save({k: torch.as_tensor(np.array(v)) for k, v in _torch_sd("vis").items()},
               hf / "pytorch_model.bin")
    (hf / "config.json").write_text(json.dumps({"num_outputs": 6}))
    jcw.main(["--model", "vis", "--src", str(hf), "--dst", str(tmp_path / "jax.pt"),
              "--to", "torch"])
    tcw.main(["--model", "vis", "--src", str(hf), "--dst", str(tmp_path / "port.pt"),
              "--to", "torch"])
    _assert_sd_equal(checkpoint.load_torch_checkpoint(str(tmp_path / "port.pt")),
                     checkpoint.load_torch_checkpoint(str(tmp_path / "jax.pt")))


@pytest.mark.parametrize("model", ["vis", "vit", "he2rna"])
def test_convert_pt_to_dcp_and_back_bit_equal(tmp_path, model):
    src = tmp_path / "src.pt"
    checkpoint.save_torch_state_dict(_torch_sd(model), str(src))
    tcw.main(["--model", model, "--src", str(src), "--dst", str(tmp_path / "dcp"),
              "--to", "dcp"])
    assert (tmp_path / "dcp" / tcw.CONFIG_FILE).exists()
    tcw.main(["--model", model, "--src", str(tmp_path / "dcp"), "--dst",
              str(tmp_path / "back.pt"), "--to", "torch"])
    _assert_sd_equal(checkpoint.load_torch_checkpoint(str(tmp_path / "back.pt")),
                     checkpoint.load_torch_checkpoint(str(src)))
    # the DCP directory holds the port's tree, equal to the JAX tool's params
    cfg, params = tcw.load_dcp(str(tmp_path / "dcp"), model)
    want_cfg, _ = tcw.FROM_TORCH[model](checkpoint.load_torch_checkpoint(str(src)))
    assert cfg == want_cfg


def test_convert_to_orbax_writes_dcp_and_says_so(tmp_path, capsys):
    src = tmp_path / "src.pt"
    cfg, params = _vis_jax()
    checkpoint.save_torch_state_dict(jconvert.vis_to_torch(cfg, params), str(src))
    tcw.main(["--model", "vis", "--src", str(src), "--dst", str(tmp_path / "orb"),
              "--to", "orbax"])
    assert "torch.distributed.checkpoint" in capsys.readouterr().err
    _, tparams = tcw.load_dcp(str(tmp_path / "orb"), "vis")
    # the JAX tool's Orbax tree holds the same leaves
    for k in ("pos_emb", "head_w", "head_b"):
        np.testing.assert_array_equal(tparams[k].numpy(), np.asarray(params[k]))
    for k, v in params["blocks"].items():
        np.testing.assert_array_equal(tparams["blocks"][k].numpy(), np.asarray(v))
    with pytest.raises(ValueError, match="holds a vis checkpoint"):
        tcw.load_dcp(str(tmp_path / "orb"), "vit")
