"""Convert checkpoints between the reference's torch formats and the port's.

Counterpart of ``tools/convert_weights.py``.  The JAX tool's Orbax side is the
port's ``torch.distributed.checkpoint`` directory (``train/checkpoint.py``
``save_sharded``/``load_sharded``) of the port's parameter tree, with the
architecture beside it in ``sequoia_config.json`` so that the directory
converts back on its own.  ``--to orbax`` is taken for the JAX command lines
and writes that directory too (said on stderr).

    # released HF fold weights (local snapshot dir or .pt/.bin) -> DCP
    python -m sequoia_tpu_torch.tools.convert_weights --model vis \\
        --src sequoia-brca-0/ --dst ckpt_brca0 --to dcp

    # a DCP directory (or a .pt) -> reference-loadable torch .pt
    python -m sequoia_tpu_torch.tools.convert_weights --model vis \\
        --src ckpt_brca0 --dst model_best_0.pt --to torch
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from sequoia_tpu_torch.models import convert
from sequoia_tpu_torch.models.he2rna import HE2RNAConfig
from sequoia_tpu_torch.models.vis import ViSConfig
from sequoia_tpu_torch.models.vit import ViTConfig
from sequoia_tpu_torch.train import checkpoint

FROM_TORCH = {"vis": convert.vis_from_torch, "vit": convert.vit_from_torch,
              "he2rna": convert.he2rna_from_torch}
TO_TORCH = {"vis": convert.vis_to_torch, "vit": convert.vit_to_torch,
            "he2rna": convert.he2rna_to_torch}
CONFIGS = {"vis": ViSConfig, "vit": ViTConfig, "he2rna": HE2RNAConfig}
#: the architecture of a DCP directory this tool wrote
CONFIG_FILE = "sequoia_config.json"


def _unflatten(flat: dict):
    """``load_sharded``'s ``{"a.b.0": tensor}`` -> the nested tree, a level
    whose keys are all indices becoming a list."""
    tree: dict = {}
    for key, v in flat.items():
        node, parts = tree, key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def save_dcp(path: str, model: str, cfg, params) -> None:
    checkpoint.save_sharded(path, params)
    fields = {k: list(v) if isinstance(v, tuple) else v
              for k, v in dataclasses.asdict(cfg).items()}
    with open(os.path.join(path, CONFIG_FILE), "w") as f:
        json.dump({"model": model, "config": fields}, f, indent=1)


def load_dcp(path: str, model: str):
    """(cfg, params) of a directory :func:`save_dcp` wrote."""
    with open(os.path.join(path, CONFIG_FILE)) as f:
        meta = json.load(f)
    if meta["model"] != model:
        raise ValueError(f"{path} holds a {meta['model']} checkpoint, not {model}")
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["config"].items()}
    return CONFIGS[model](**fields), _unflatten(checkpoint.load_sharded(path))


def load_any(model: str, src: str):
    """-> (cfg, params) from a torch .pt/.bin, an HF snapshot dir or a DCP dir."""
    if os.path.isdir(src):
        if os.path.exists(os.path.join(src, CONFIG_FILE)):
            return load_dcp(src, model)
        sd = checkpoint.load_hf_vis_state_dict(src)
    else:
        sd = checkpoint.load_torch_checkpoint(src)
    return FROM_TORCH[model](sd)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Checkpoint converter")
    p.add_argument("--model", required=True, choices=["vis", "vit", "he2rna"])
    p.add_argument("--src", required=True,
                   help="torch .pt/.bin, HF snapshot dir, or DCP dir")
    p.add_argument("--dst", required=True)
    p.add_argument("--to", required=True, choices=["torch", "dcp", "orbax"],
                   help="orbax: the JAX tool's name, writes a DCP directory")
    args = p.parse_args(argv)

    cfg, params = load_any(args.model, args.src)
    print(f"loaded {args.model}: {cfg}")
    if args.to == "torch":
        checkpoint.save_torch_state_dict(TO_TORCH[args.model](cfg, params), args.dst)
    else:
        if args.to == "orbax":
            print("convert_weights: --to orbax writes a torch.distributed.checkpoint "
                  "directory (the port's sharded format)", file=sys.stderr)
        save_dcp(args.dst, args.model, cfg, params)
    print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
