"""The port's ``validate_real_weights`` (``sequoia_tpu_torch/tools/``) on the
fixtures of ``tests/test_validate_real_weights.py`` (hub-layout artifacts
built from JAX-converted params, the reference's whole-module HE2RNA pickle
among them): every row within the JAX tool's bound; the port's forward
within that bound of the JAX forward on the same input; skip-clean without a
hub; non-zero on an artifact that does not load.  The kernel routes run the
kernels' plain versions on the CPU."""

import json
import sys
import types

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax

from sequoia_tpu.models import convert as jconvert
from sequoia_tpu.models import he2rna as jhe2rna
from sequoia_tpu.models import resnet as jresnet
from sequoia_tpu.models import uni_vit as juni
from sequoia_tpu.models import vis as jvis
from sequoia_tpu.models import vit as jvit
from sequoia_tpu_torch.tools import goldens
from sequoia_tpu_torch.tools import validate_real_weights as vrw
from tests import torch_goldens
from tools import validate_real_weights as jvrw

# a fold that K1's packed layout takes (nheads * dim = 128, input_dim 256)
K1_VIS = dict(num_outputs=6, input_dim=256, depth=1, nheads=2, dim_f=64, dim_s=64, dim_c=64,
              num_clusters=5)
SMALL_VIS = dict(num_outputs=6, input_dim=32, depth=1, nheads=2, dim_f=4, dim_s=4, dim_c=4,
                 num_clusters=5)


def jax_params(init, cfg, seed: int):
    """A JAX parameter tree with ``init``'s structure and shapes, filled from a
    numpy seed: LayerNorm scales near 1, weights scaled by 1/sqrt(fan in),
    the rest small (tracing ``init`` is quicker than running it)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        key = str(path[-1].key if hasattr(path[-1], "key") else path[-2].key)
        if "scale" in key:
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if key.startswith("w") and len(s.shape) >= 2:
            return (rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: init(cfg, k), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _save(sd: dict, path):
    torch.save({k: torch.as_tensor(np.array(v)) for k, v in sd.items()}, path)


def _vis_fixture(hub, name, fields, seed=0):
    cfg = jvis.ViSConfig(**fields)
    d = hub / name
    d.mkdir(parents=True)
    _save(jconvert.vis_to_torch(cfg, jax_params(jvis.init, cfg, seed)), d / "pytorch_model.bin")
    (d / "config.json").write_text(json.dumps({"num_outputs": cfg.num_outputs,
                                               "input_dim": cfg.input_dim}))


@pytest.fixture(scope="module")
def hub(tmp_path_factory):
    """Every artifact kind the tool reads, as tests/test_validate_real_weights.py
    fabricates them."""
    hub = tmp_path_factory.mktemp("hub")
    _vis_fixture(hub, "sequoia-test-0", SMALL_VIS)
    _vis_fixture(hub, "sequoia-test-1", K1_VIS, seed=3)
    torch.save({k: v.float() for k, v in torch_goldens.resnet50_sd(
        torch.Generator().manual_seed(0)).items()}, hub / "resnet50.pth")
    (hub / "uni").mkdir()
    torch.save(torch_goldens.uni_sd(torch.Generator().manual_seed(1)),
               hub / "uni" / "pytorch_model.bin")
    (hub / "uni" / "config.json").write_text(json.dumps({"num_heads": 4}))
    vcfg = jvit.ViTConfig(num_outputs=6, dim=64, depth=1, heads=2, dim_head=64, mlp_dim=16,
                          num_clusters=5)
    _save(jconvert.vit_to_torch(vcfg, jax_params(jvit.init, vcfg, 1)), hub / "vit-test.pt")
    hcfg = jhe2rna.HE2RNAConfig(input_dim=16, output_dim=6, layers=(8, 8), ks=(1, 2, 5))
    hsd = {k: torch.as_tensor(np.array(v)) for k, v in jconvert.he2rna_to_torch(
        hcfg, jax_params(jhe2rna.init, hcfg, 2)).items()}
    torch.save(hsd, hub / "he2rna-test.pt")
    # the reference's whole-module pickle (he2rna.py:301), of a class that is
    # importable only while it is written
    mod = types.ModuleType("he2rna_ref_module")

    class HE2RNA(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv0 = nn.Conv1d(16, 8, 1)
            self.conv1 = nn.Conv1d(8, 8, 1)
            self.conv2 = nn.Conv1d(8, 6, 1)

    HE2RNA.__module__ = mod.__name__
    HE2RNA.__qualname__ = "HE2RNA"
    mod.HE2RNA = HE2RNA
    sys.modules[mod.__name__] = mod
    try:
        m = HE2RNA()
        m.load_state_dict(hsd)
        torch.save(m, hub / "he2rna-module.pt")
    finally:
        del sys.modules[mod.__name__]
    return hub


def test_offline_hub_every_row_passes(hub, tmp_path, capsys):
    notes = tmp_path / "NOTES.md"
    rc = vrw.main(["--cancers", "test", "--folds", "0,1", "--local-hub", str(hub),
                   "--notes", str(notes), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, out["rows"]
    rows = out["rows"]
    # 2 ViS folds (+ K1 on the one that fits), 3 ResNet routes, UNI, ViT, 2 HE2RNA
    assert set(rows) == {
        "gevaertlab/sequoia-test-0 [plain]", "gevaertlab/sequoia-test-1 [plain]",
        "gevaertlab/sequoia-test-1 [K1 vis_blocks_fused]",
        "torchvision/resnet50-IMAGENET1K_V1 [plain]",
        "torchvision/resnet50-IMAGENET1K_V1 [K2+K3 early_pallas]",
        "torchvision/resnet50-IMAGENET1K_V1 [K4 fused_stages]", "MahmoodLab/UNI [plain]",
        "local/vit-test.pt [plain]", "local/he2rna-test.pt [plain]",
        "local/he2rna-module.pt [plain]"}
    assert out["validated"] == out["passed"] == 10 and out["pending"] == 0
    for name, row in rows.items():
        assert row["pass"] and row["max_abs"] <= 1e-2 and row["corr"] > 0.99999, name
    assert "K1 not run" in rows["gevaertlab/sequoia-test-0 [plain]"]["kernel"]
    assert rows["gevaertlab/sequoia-test-1 [K1 vis_blocks_fused]"]["vs_plain_max_abs"] < 1e-4
    text = notes.read_text()
    assert text.count(vrw.NOTES_BEGIN) == 1 and "PASS" in text and "FAIL" not in text
    assert "Pending" not in text


def _jax_rows(hub) -> dict:
    """The JAX tool's rows on the same fixtures (its own float64 oracle)."""
    rng = np.random.default_rng(0)
    return {"vis": jvrw.check_vis(str(hub / "sequoia-test-1"), rng),
            "he2rna": jvrw.check_he2rna(str(hub / "he2rna-test.pt"), rng)}


def test_port_forward_within_the_jax_bound_of_the_jax_forward(hub):
    """The same input through the port's routes and the JAX forward: each
    within the JAX tool's bound of the other."""
    rng = np.random.default_rng(7)

    def jit(fn, cfg, params, x):
        return np.asarray(jax.jit(lambda p, v: fn(cfg, p, v))(params, x))

    sd = vrw.load_state_dict(str(hub / "sequoia-test-1"))
    x = rng.normal(size=(2, 5, 256)).astype(np.float32)
    cases = [(vrw.vis_forwards(sd, x, "cpu")[0], jit(jvis.apply, *jconvert.vis_from_torch(
        dict(sd)), x))]
    sd = vrw.load_state_dict(str(hub / "vit-test.pt"))
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    cases.append((vrw.vit_forwards(sd, x, "cpu")[0],
                  jit(jvit.apply, *jconvert.vit_from_torch(dict(sd)), x)))
    sd = vrw.load_state_dict(str(hub / "he2rna-module.pt"))
    x = rng.normal(size=(2, 100, 16)).astype(np.float32)
    cases.append((vrw.he2rna_forwards(sd, x, "cpu")[0],
                  jit(jhe2rna.apply, *jconvert.he2rna_from_torch(dict(sd)), x)))
    sd = vrw.load_state_dict(str(hub / "resnet50.pth"))
    u8 = rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    cases.append((vrw.resnet50_forwards(sd, u8, "cpu")[0],
                  jit(jresnet.extract_from_uint8, *jresnet.resnet_from_torch(sd), u8)))
    sd = vrw.load_state_dict(str(hub / "uni" / "pytorch_model.bin"))
    u8 = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    cases.append((vrw.uni_forwards(sd, u8, "cpu", heads=4)[0],
                  jit(juni.extract_from_uint8, *juni.uni_from_torch(sd, heads=4), u8)))
    routes = 0
    for outs, want in cases:
        oracle = outs.pop("oracle")
        assert jvrw._delta_row(want, oracle, {})["pass"]
        for route, got in outs.items():
            row = jvrw._delta_row(got, want, {})
            assert row["pass"], (route, row)
            routes += 1
    assert routes == 2 + 1 + 1 + 3 + 1


def test_rows_agree_with_the_jax_tools_rows(hub):
    """The port's plain row and the JAX tool's row on one seeded input: the
    same draws, each a small delta from its oracle."""
    rng = np.random.default_rng(0)
    port = {"vis": vrw.check("vis", str(hub / "sequoia-test-1"), rng, "cpu"),
            "he2rna": vrw.check("he2rna", str(hub / "he2rna-test.pt"), rng, "cpu")}
    for kind, want in _jax_rows(hub).items():
        got = port[kind]["plain"]
        assert got["pass"] and want["pass"]
        assert got["genes"] == want["genes"]


def test_no_hub_is_pending_and_exits_zero(tmp_path, capsys):
    notes = tmp_path / "NOTES.md"
    rc = vrw.main(["--cancers", "brca", "--folds", "0", "--notes", str(notes),
                   "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["validated"] == 0 and out["pending"] == 3
    text = notes.read_text()
    assert "Pending: no local hub" in text
    assert "gevaertlab/sequoia-brca-0 (vis)" in text and "MahmoodLab/UNI (uni)" in text


def test_cache_snapshot_is_read_without_a_hub(hub, tmp_path, capsys):
    snap = tmp_path / "cache" / "models--gevaertlab--sequoia-test-0" / "snapshots" / "abc"
    snap.parent.mkdir(parents=True)
    import shutil

    shutil.copytree(hub / "sequoia-test-0", snap)
    rc = vrw.main(["--cancers", "test", "--folds", "0", "--cache", str(tmp_path / "cache"),
                   "--skip-uni", "--skip-resnet", "--notes", str(tmp_path / "N.md"),
                   "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["validated"] == out["passed"] == 1 and out["pending"] == 0


def test_wrong_shaped_tensor_exits_nonzero(hub, tmp_path, capsys):
    bad = tmp_path / "badhub"
    _vis_fixture(bad, "sequoia-test-0", SMALL_VIS)
    sd = torch.load(bad / "sequoia-test-0" / "pytorch_model.bin")
    sd["linear_head.1.weight"] = sd["linear_head.1.weight"][:, :-1]
    torch.save(sd, bad / "sequoia-test-0" / "pytorch_model.bin")
    notes = tmp_path / "NOTES.md"
    rc = vrw.main(["--cancers", "test", "--folds", "0", "--local-hub", str(bad),
                   "--skip-uni", "--skip-resnet", "--notes", str(notes), "--device", "cpu"])
    assert rc == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    row = out["rows"]["gevaertlab/sequoia-test-0 [load]"]
    assert not row["pass"] and "error" in row
    assert "FAIL" in notes.read_text()


def test_notes_section_is_replaced_not_duplicated(tmp_path):
    notes = tmp_path / "NOTES.md"
    notes.write_text("# Parity notes\n\nhand-written content\n")
    vrw.write_notes(str(notes), {}, ["a (vis)"], "no local hub", "cpu")
    vrw.write_notes(str(notes), {"x [plain]": {"max_abs": 1e-6, "max_rel": 1e-6, "corr": 1.0,
                                               "pass": True}}, [], "no local hub", "cpu")
    text = notes.read_text()
    assert text.count(vrw.NOTES_BEGIN) == 1 and "hand-written content" in text
    assert "| x [plain] |" in text and "a (vis)" not in text


def test_dry_run_and_the_jax_notes_file(capsys):
    assert vrw.main(["--cancers", "brca,gbm", "--folds", "0,1", "--dry-run"]) == 0
    out = capsys.readouterr().out
    assert out.count("would validate vis") == 4
    assert "resnet50" in out and "MahmoodLab/UNI" in out
    assert vrw.DEFAULT_NOTES.endswith("docs/PARITY_NOTES_TORCH.md")
    with pytest.raises(SystemExit, match="JAX package"):
        vrw.main(["--notes", vrw.JAX_NOTES, "--dry-run"])


def test_goldens_are_the_tests_oracle():
    """The port's copy of the oracle computes what tests/torch_goldens.py does."""
    g = torch.Generator().manual_seed(5)
    sd = torch_goldens.resnet50_sd(g)
    x = torch.randn(1, 3, 64, 64, generator=g, dtype=torch.float64)
    torch.testing.assert_close(goldens.resnet50_forward_extract(sd, x),
                               torch_goldens.resnet50_forward_extract(sd, x), rtol=0, atol=0)
    usd = goldens.uni_sd(torch.Generator().manual_seed(1))
    for k, v in torch_goldens.uni_sd(torch.Generator().manual_seed(1)).items():
        torch.testing.assert_close(usd[k], v, rtol=0, atol=0)
    xu = torch.randn(2, 3, 32, 32, generator=g, dtype=torch.float64)
    torch.testing.assert_close(goldens.uni_forward(usd, xu), torch_goldens.uni_forward(usd, xu),
                               rtol=0, atol=0)
