"""The port's ``config.py`` against the JAX package's: the same four frozen
dataclasses with equal values (the port's ``feature_dims`` adds Virchow2,
a backbone the JAX package lacks, after JAX's), and the port CLIs' parser
defaults equal to the config wherever the JAX CLI of the same name defaults
to it."""

import dataclasses
import importlib

import pytest

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)

from sequoia_tpu import config as jconfig
from sequoia_tpu_torch import config

INSTANCES = ("AGGREGATOR", "HE2RNA", "TRAIN", "PIPELINE")
#: the port's additions to a JAX value: (instance, field) -> the entries after JAX's
PORT_ONLY = {("PIPELINE", "feature_dims"): (("virchow2", 2560),)}

# a CLI option's dest -> the config value its default stands for
DEFAULTS = {
    "depth": config.AGGREGATOR.depth,
    "num_heads": config.AGGREGATOR.num_heads,
    "num_clusters": config.PIPELINE.num_clusters,
    "lr": config.TRAIN.lr,
    "batch_size": config.TRAIN.batch_size,
    "num_epochs": config.TRAIN.num_epochs,
    "k": config.TRAIN.k_folds,
    "folds": config.TRAIN.k_folds,
    "seed": config.TRAIN.seed,
    "patch_size": config.PIPELINE.patch_size,
    "max_patch_number": config.PIPELINE.max_patches_per_slide,
    "max_patches": config.PIPELINE.max_patches_per_slide,
    "stride": config.PIPELINE.sliding_stride,
}
CLIS = ("compute_features", "he2rna", "kmean_features", "main", "patch_gen",
        "predict_independent", "pretrain_gtex", "serve", "visualize")


@pytest.mark.parametrize("name", INSTANCES)
def test_config_values_equal_jax(name):
    got, want = getattr(config, name), getattr(jconfig, name)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.is_dataclass(got) and type(got).__dataclass_params__.frozen
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    want_values = dataclasses.asdict(want)
    for (inst, field), extra in PORT_ONLY.items():
        if inst == name:
            want_values[field] = tuple(want_values[field]) + extra
    assert dataclasses.asdict(got) == want_values
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(got, dataclasses.fields(got)[0].name, None)


@pytest.mark.parametrize("cli", CLIS)
def test_port_cli_defaults_follow_the_config(cli):
    jp = importlib.import_module(f"sequoia_tpu.cli.{cli}").build_parser()
    tp = importlib.import_module(f"sequoia_tpu_torch.cli.{cli}").build_parser()
    held = [d for d, v in DEFAULTS.items()
            if d in {a.dest for a in jp._actions} and jp.get_default(d) == v]
    assert held, f"cli.{cli} defaults to no config value"
    for dest in held:
        assert tp.get_default(dest) == DEFAULTS[dest], f"cli.{cli} --{dest}"


def test_feature_dims_name_every_backbone_at_its_width():
    """``feature_dims`` names each ``feat_type`` the port serves, with the
    width its default backbone gives (Virchow2: CLS ⊕ patch mean, 2560)."""
    from sequoia_tpu_torch.models import resnet
    from sequoia_tpu_torch.pipeline.features import FEAT_TYPES, vit_config

    dims = dict(config.PIPELINE.feature_dims)
    assert tuple(dims) == FEAT_TYPES
    assert dims["resnet"] == resnet.ResNetConfig().feature_dim_for(256, 256)
    for name in FEAT_TYPES[1:]:
        assert dims[name] == vit_config(name).feature_dim, name
