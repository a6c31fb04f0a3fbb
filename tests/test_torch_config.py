"""The port's ``config.py`` against the JAX package's: the same four frozen
dataclasses with equal values, and the port CLIs' parser defaults equal to
the config wherever the JAX CLI of the same name defaults to it."""

import dataclasses
import importlib

import pytest

import jax  # noqa: F401  (JAX on the CPU, tests/conftest.py)

from sequoia_tpu import config as jconfig
from sequoia_tpu_torch import config

INSTANCES = ("AGGREGATOR", "HE2RNA", "TRAIN", "PIPELINE")

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
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
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
