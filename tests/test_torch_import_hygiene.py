"""The PyTorch port imports nothing of JAX or of the JAX package, builds and
imports no kernel toolchain at import time, imports none of the packages the
GPU machine lacks (pandas, h5py, Pillow, safetensors, huggingface_hub,
openslide, sklearn, cv2, scanpy, matplotlib, seaborn) or wandb when a module
is imported, and its entry points refuse to run on the CPU unless asked to."""

import ast
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "sequoia_tpu", "tests", "tools"}
# imported inside the function that needs them, never at module level
LAZY = {"pandas", "h5py", "PIL", "safetensors", "huggingface_hub", "openslide", "triton",
        "wandb", "sklearn", "cv2", "scanpy", "matplotlib", "seaborn"}
# the serving slice: checkpoints, the CLI, the HTTP server, the native reader
SLICE_MODULES = ("sequoia_tpu_torch/train/checkpoint.py", "sequoia_tpu_torch/cli/serve.py",
                 "sequoia_tpu_torch/cli/compute_features.py", "sequoia_tpu_torch/http_serve.py",
                 "sequoia_tpu_torch/native/__init__.py", "sequoia_tpu_torch/utils/profiling.py",
                 "sequoia_tpu_torch/bench_serving.py")
# the aggregators slice: HE2RNA trained and served, spatial maps,
# independent-cohort prediction
AGGREGATOR_MODULES = ("sequoia_tpu_torch/models/he2rna.py",
                      "sequoia_tpu_torch/train/he2rna_fit.py",
                      "sequoia_tpu_torch/cli/he2rna.py", "sequoia_tpu_torch/pipeline/spatial.py",
                      "sequoia_tpu_torch/cli/visualize.py",
                      "sequoia_tpu_torch/evaluation/__init__.py",
                      "sequoia_tpu_torch/evaluation/predict_independent.py",
                      "sequoia_tpu_torch/cli/predict_independent.py")
# the stages and evaluation slice: tiling, features and k-means stages and
# their CLIs, the evaluation modules and theirs
STAGE_MODULES = ("sequoia_tpu_torch/pipeline/kmeans_stage.py",
                 "sequoia_tpu_torch/cli/patch_gen.py", "sequoia_tpu_torch/cli/kmean_features.py",
                 "sequoia_tpu_torch/evaluation/correlation_stats.py",
                 "sequoia_tpu_torch/evaluation/evaluate_model.py",
                 "sequoia_tpu_torch/evaluation/spatial_metrics.py",
                 "sequoia_tpu_torch/evaluation/gbm_modules.py",
                 "sequoia_tpu_torch/cli/evaluate_model.py", "sequoia_tpu_torch/cli/get_emd.py",
                 "sequoia_tpu_torch/cli/gbm_analysis.py")
# the training slice
TRAIN_MODULES = ("sequoia_tpu_torch/ops/stats.py", "sequoia_tpu_torch/data/splits.py",
                 "sequoia_tpu_torch/data/dataset.py", "sequoia_tpu_torch/utils/logging.py",
                 "sequoia_tpu_torch/models/vit.py", "sequoia_tpu_torch/train/loop.py",
                 "sequoia_tpu_torch/train/cv.py", "sequoia_tpu_torch/cli/main.py",
                 "sequoia_tpu_torch/cli/pretrain_gtex.py")

# the multi-GPU slice: meshes, ranks, sharded checkpoints, the dry run
PARALLEL_MODULES = ("sequoia_tpu_torch/parallel/__init__.py",
                    "sequoia_tpu_torch/parallel/multihost.py",
                    "sequoia_tpu_torch/parallel/sharding.py", "sequoia_tpu_torch/dryrun.py")


# the last slice: raw-plane serving's ops, the config, the GDC downloader
LAST_MODULES = ("sequoia_tpu_torch/ops/ycbcr.py", "sequoia_tpu_torch/ops/mosaic.py",
                "sequoia_tpu_torch/config.py", "sequoia_tpu_torch/cli/download_rnaseq.py")


# the tool layer: the counterparts of the repo's tools/*.py
TOOL_MODULES = tuple(f"sequoia_tpu_torch/tools/{name}.py" for name in (
    "__init__", "make_example_data", "import_reference_artifacts", "parity_check",
    "convert_weights", "goldens", "validate_real_weights", "profile_backbone",
    "profile_train_step"))


# the benchmark slice: the H100's peak rates and ViS work counts, dryrun.py's entry()
BENCH_MODULES = ("sequoia_tpu_torch/bench.py", "sequoia_tpu_torch/dryrun.py")


def _port_files():
    return sorted((ROOT / "sequoia_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_names(tree):
    """Top-level package names of every import anywhere in the module."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def _module_level_imports(tree):
    """Imports executed when the module is imported (not inside a def)."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            yield node
        elif isinstance(node, (ast.If, ast.Try, ast.With)):
            for field in ("body", "orelse", "finalbody", "handlers"):
                stack.extend(getattr(node, field, []))
        elif isinstance(node, ast.ExceptHandler):
            stack.extend(node.body)


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for want in ("sequoia_tpu_torch/serve.py", "sequoia_tpu_torch/ops/cuda_vis.py",
                 "sequoia_tpu_torch/ops/cuda_resnet.py",
                 "sequoia_tpu_torch/ops/cuda_kmeans.py", "sequoia_tpu_torch/ops/masking.py",
                 "sequoia_tpu_torch/data/wsi.py", "sequoia_tpu_torch/pipeline/patch_gen.py",
                 "sequoia_tpu_torch/models/uni_vit.py", "sequoia_tpu_torch/ops/pil_resize.py",
                 "chip_smoke.py", *SLICE_MODULES, *TRAIN_MODULES, *AGGREGATOR_MODULES,
                 *STAGE_MODULES, *PARALLEL_MODULES, *LAST_MODULES, *TOOL_MODULES,
                 *BENCH_MODULES):
        assert want in names


def test_only_the_pallas_modules_are_jax_only():
    """Every module of the JAX package has a counterpart in the port but the
    three Pallas kernel files, whose kernels are ``csrc/*.cu``."""
    def modules(pkg):
        root = ROOT / pkg
        return {p.relative_to(root).as_posix() for p in root.rglob("*.py")}

    assert modules("sequoia_tpu") - modules("sequoia_tpu_torch") == {
        "ops/pallas_vis.py", "ops/pallas_resnet.py", "ops/pallas_kmeans.py"}


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_package_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    # exact top-level names: ``sequoia_tpu_torch`` itself is allowed
    bad = [(line, name) for line, name in _imported_names(tree) if name in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_module_level_lazy_import(path):
    """triton, and the packages the GPU machine lacks, only inside a def."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in _module_level_imports(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""])
        bad = [n for n in names if n.split(".")[0] in LAZY]
        assert not bad, f"{path.name} imports {bad} at module level"


def test_example_pipeline_script_runs_no_jax_tool():
    """The port's example pipeline runs the port's tools, no ``tools/*.py``
    (those import the JAX package)."""
    script = (ROOT / "tools" / "run_example_pipeline_torch.sh").read_text()
    commands = [line for line in script.splitlines() if not line.lstrip().startswith("#")]
    assert not [line for line in commands if re.search(r"tools/\w+\.py", line)]
    assert "sequoia_tpu_torch.tools.make_example_data" in script
    assert "sequoia_tpu_torch.tools.import_reference_artifacts" in script


def test_import_loads_no_jax_module():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sequoia_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'sequoia_tpu', 'triton', 'pandas', 'h5py', 'PIL', "
        "'safetensors', 'huggingface_hub', 'openslide', 'wandb', 'sklearn', 'cv2', "
        "'scanpy', 'matplotlib', 'seaborn'))\n"
        "from sequoia_tpu_torch import native\n"
        "if native._lib is not None or native._error is not None:\n"
        "    bad.append('native library built at import')\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_parallel_import_starts_nothing():
    """Importing the multi-GPU modules (and the CLIs that take their flags)
    initialises no CUDA context, starts no process group and spawns no
    process."""
    code = (
        "import multiprocessing, torch, torch.distributed as dist\n"
        "import sequoia_tpu_torch.parallel, sequoia_tpu_torch.parallel.multihost\n"
        "import sequoia_tpu_torch.parallel.sharding, sequoia_tpu_torch.dryrun\n"
        "import sequoia_tpu_torch.cli.main, sequoia_tpu_torch.cli.serve\n"
        "import sequoia_tpu_torch.train.checkpoint\n"
        "print(torch.cuda.is_initialized(), dist.is_initialized(),\n"
        "      len(multiprocessing.active_children()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.split() == ["False", "False", "0"], out.stdout + out.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    from sequoia_tpu_torch.models import resnet, vis
    from sequoia_tpu_torch.ops import kmeans
    from sequoia_tpu_torch.pipeline.features import FeatureExtractor
    from sequoia_tpu_torch.pipeline.fused import make_slide_program
    from sequoia_tpu_torch.serve import SlidePredictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = resnet.random_params(torch.Generator().manual_seed(0))
    cfg = vis.ViSConfig(num_outputs=4, input_dim=256, depth=1, nheads=4, dim_f=32,
                        dim_s=32, dim_c=32, num_clusters=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        FeatureExtractor("resnet", params)
    with pytest.raises(RuntimeError, match="CUDA"):
        FeatureExtractor("uni", {})
    with pytest.raises(RuntimeError, match="CUDA"):
        make_slide_program(params, cfg, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        make_slide_program({}, cfg, {}, backbone="uni")
    with pytest.raises(RuntimeError, match="CUDA"):
        SlidePredictor(None, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        kmeans.kmeans_cluster_features(np.zeros((8, 4), np.float32), n_clusters=2)
    from sequoia_tpu_torch.pipeline import kmeans_stage

    with pytest.raises(RuntimeError, match="CUDA"):
        kmeans_stage.run_kmeans(None, "features")

    from sequoia_tpu_torch.train import cv, loop

    with pytest.raises(RuntimeError, match="CUDA"):
        loop.train(lambda p, x: x, {"w": torch.zeros(2)}, loop.make_adamw, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.evaluate(lambda p, x: x, {"w": torch.zeros(2)}, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.predict(lambda p, x: x, {"w": torch.zeros(2)}, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        cv.run_cross_validation(None, "features", "out")

    from sequoia_tpu_torch.evaluation import predict_independent as pi
    from sequoia_tpu_torch.models import he2rna
    from sequoia_tpu_torch.train import he2rna_fit

    hcfg = he2rna.HE2RNAConfig(input_dim=4, output_dim=2, layers=(3,), ks=(1,))
    hp = {"w": [torch.zeros(4, 3), torch.zeros(3, 2)], "b": [torch.zeros(3), torch.zeros(2)]}
    for call in (lambda: he2rna_fit.fit(hcfg, hp, 1e-3, [], None, None),
                 lambda: he2rna_fit.he2rna_evaluate(hcfg, hp, []),
                 lambda: he2rna_fit.he2rna_predict(hcfg, hp, []),
                 lambda: cv.run_he2rna_cross_validation(None, "features", "out"),
                 lambda: pi.ensemble_predict(cfg, [], []),
                 lambda: pi.predict_independent(None, "features", "out",
                                                checkpoint_template="x{fold}")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_bench_and_entry_raise_without_cuda(monkeypatch):
    """``dryrun.entry`` runs on CUDA unless given the CPU, and importing
    ``bench`` and ``dryrun`` touches no GPU and no lazily imported package."""
    code = ("import sys, torch\n"
            "import sequoia_tpu_torch.bench, sequoia_tpu_torch.dryrun\n"
            "print(torch.cuda.is_initialized(), sorted(m for m in sys.modules\n"
            "      if m.split('.')[0] in ('pandas', 'h5py', 'PIL', 'jax', 'sequoia_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "False []", out.stdout + out.stderr
    from sequoia_tpu_torch import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.entry()


def test_unported_options_raise():
    from sequoia_tpu_torch.models import resnet, vis
    from sequoia_tpu_torch.ops import kmeans
    from sequoia_tpu_torch.pipeline.features import FeatureExtractor
    from sequoia_tpu_torch.pipeline.fused import make_slide_program
    from sequoia_tpu_torch.serve import SlidePredictor

    params = resnet.random_params(torch.Generator().manual_seed(0))
    # the mesh options run since the multi-GPU slice; a mesh of the wrong kind
    # is a TypeError, an uneven batch JAX's ValueError
    from sequoia_tpu_torch.parallel.sharding import make_mesh

    with pytest.raises(TypeError, match="sharding.Mesh"):
        FeatureExtractor("uni", params, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="not divisible by mesh data axis"):
        FeatureExtractor("resnet", params, batch_size=3, device="cpu",
                         mesh=make_mesh(2, devices=["cpu", "cpu"]))
    # ported since the stages slice: the host's sklearn where it imports
    assert kmeans.kmeans_cluster_features(np.arange(32, dtype=np.float32).reshape(8, 4),
                                          n_clusters=2, backend="sklearn").shape == (2, 4)
    cfg = vis.ViSConfig(num_outputs=4, input_dim=256, depth=1, nheads=4, dim_f=32,
                        dim_s=32, dim_c=32, num_clusters=4)
    with pytest.raises(ValueError, match="backbone"):
        make_slide_program(params, cfg, {}, backbone="vit", device="cpu")
    for model_type in ("vit", "he2rna"):  # served since the aggregators slice
        assert SlidePredictor(None, [], model_type=model_type, device="cpu").model_type \
            == model_type

    from sequoia_tpu_torch.cli import pretrain_gtex, visualize
    from sequoia_tpu_torch.pipeline import spatial
    from sequoia_tpu_torch.train import cv, loop

    with pytest.raises(TypeError, match="GlobalMesh"):
        loop.train(lambda p, x: x, {"w": torch.zeros(2)}, loop.make_adamw, {}, mesh=object(),
                   device="cpu")
    with pytest.raises(TypeError, match="GlobalMesh"):
        cv.run_cross_validation(None, "features", "out", mesh=object(), device="cpu")
    assert pretrain_gtex.build_parser().parse_args(
        ["--path_csv", "x.csv", "--model", "he2rna"]).model == "he2rna"
    import pandas as pd

    df = pd.DataFrame({"xcoord_tf": np.arange(3), "ycoord_tf": np.zeros(3, int)})
    with pytest.raises(ValueError, match="stacked predictor"):
        spatial.sliding_window_predict_arrays(np.zeros((3, 4), np.float32), df, {}, [0],
                                              mesh=object())
    for call in (lambda: spatial.make_vis_stacked_predict_fn(cfg, {0: None}, mesh=object()),
                 lambda: spatial.run_visualize(None, None, [], {}, None, mesh=object())):
        with pytest.raises(TypeError, match="sharding.Mesh"):
            call()
    assert visualize.build_parser().parse_args(
        ["--study", "s", "--project", "p", "--wsi_file_name", "w", "--save_folder", "f",
         "--model_type", "vis", "--feat_type", "resnet", "--weights", "random",
         "--data_parallel"]).data_parallel


def test_kernel_build_needs_nvcc(monkeypatch):
    """Without nvcc the build raises instead of falling back."""
    from sequoia_tpu_torch import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()
