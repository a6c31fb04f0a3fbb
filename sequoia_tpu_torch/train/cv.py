"""5-fold patient cross-validation of the ViS and the ViT (reference
``src/main.py``) and of HE2RNA (the reference ``src/he2rna.py`` __main__).

Counterpart of ``sequoia_tpu/train/cv.py``.  Output contract, the
reference's: ``test_results.pkl`` = ``{'split_{i}': {'real', 'preds',
'random', 'wsi_file_name', 'tcga_project'}, 'genes': [...]}`` (pickle HIGHEST
protocol); for the ViS and the ViT ``model_best_{i}.pt`` torch state dicts and
``{train,val,test}_{i}.npy`` patient ids, for HE2RNA ``model_{i}.pt``; and,
with ``hf_export``, ``hf_fold_{i}/`` hub directories.

Initial weights come from one ``torch.Generator`` seeded with ``seed`` (the
fold's model, its new head where one is swapped in, then its random null
model, in that order), so they differ from the JAX package's PRNG draws; the
splits and the batch stream are the JAX package's.
"""

from __future__ import annotations

import functools
import os
import pickle

import numpy as np
import torch

from sequoia_tpu_torch.data import dataset as ds
from sequoia_tpu_torch.data import splits as sp
from sequoia_tpu_torch.models import convert, he2rna, vis, vit
from sequoia_tpu_torch.train import checkpoint, he2rna_fit, loop
from sequoia_tpu_torch.utils.device import resolve_device, tree_to

_MODELS = {"vis": vis, "vit": vit}


def _apply_fn(model_type: str, cfg):
    """The model's ``(params, x) -> (B, G)``, with ``head_input``: the same
    model up to its gene head (what a split head needs)."""
    mod = _MODELS[model_type]

    def apply_fn(p, x):
        return mod.apply(cfg, p, x)

    apply_fn.head_input = lambda p, x: mod.head_input(cfg, p, x)
    return apply_fn


def build_model(model_type: str, num_outputs: int, feature_dim: int, gen: torch.Generator,
                depth: int = 6, num_heads: int = 16, num_clusters: int = 100,
                compute_dtype: str | None = None):
    """The reference ``main.py`` model factory (vis/vit) -> (cfg, params,
    apply_fn, to_torch, from_torch); the params are drawn from ``gen`` on its
    device."""
    if model_type == "vit":
        cfg = vit.ViTConfig(num_outputs=num_outputs, dim=feature_dim, depth=depth,
                            heads=num_heads, mlp_dim=2048, dim_head=64,
                            num_clusters=num_clusters, compute_dtype=compute_dtype)
        return (cfg, vit.init(cfg, gen), _apply_fn("vit", cfg), convert.vit_to_torch,
                convert.vit_from_torch)
    if model_type == "vis":
        cfg = vis.ViSConfig(num_outputs=num_outputs, input_dim=feature_dim, depth=depth,
                            nheads=num_heads, dim_f=64, dim_s=64, dim_c=64,
                            num_clusters=num_clusters, compute_dtype=compute_dtype)
        return (cfg, vis.init(cfg, gen), _apply_fn("vis", cfg), convert.vis_to_torch,
                convert.vis_from_torch)
    raise ValueError('model_type must be "vit" or "vis"')


def _fold_checkpoint(checkpoint_path: str, i: int) -> str:
    """``model_best_{i}.pt`` under ``checkpoint_path``; for fold 0 also the
    reference's ``model_best.pt`` (its falsy ``if split:``, vit.py:124-127)."""
    candidates = [f"model_best_{i}.pt"] + (["model_best.pt"] if i == 0 else [])
    for name in candidates:
        path = os.path.join(checkpoint_path, name)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no {' / '.join(candidates)} under {checkpoint_path}")


def run_cross_validation(
        df, feature_path: str, save_dir: str, *, model_type: str = "vis",
        depth: int = 6, num_heads: int = 16, k: int = 5, batch_size: int = 16,
        lr: float = 1e-3, num_epochs: int = 200, seed: int = 99,
        save_on: str = "loss", stop_on: str = "loss", do_train: bool = True,
        hf_export: bool = False, checkpoint_path: str | None = None,
        change_num_genes: int = 0, log_fn=None, verbose: bool = True,
        resume: bool = False, mesh=None, eval_on: str = "final",
        compute_dtype: str | None = None, moment_dtype: str | None = None,
        device=None) -> dict:
    """The reference ``src/main.py`` flow on ``device`` (cuda unless asked
    otherwise): per fold, train, evaluate the test fold, evaluate a random
    model (the significance null), then write ``test_results.pkl``.

    ``checkpoint_path``: continue from fold checkpoints (a directory of
    ``model_best_{i}.pt``), or, with ``change_num_genes`` (the checkpoint's
    gene count), fine-tune one pretrained ``.pt`` whose head is swapped for a
    fresh one of this cohort's width.  ``compute_dtype="bfloat16"`` runs the
    blocks in bf16 and casts the feature batches on the host;
    ``moment_dtype`` picks ``loop.make_adamw``'s moment storage.
    ``eval_on="final"`` (the reference's behaviour) evaluates the last
    epoch's weights, ``"best"`` the saved best; ``hf_export`` publishes the
    best-val weights.

    ``mesh``: a ``parallel.multihost.GlobalMesh``; every rank runs this
    call.  Training is sharded (``loop.train(mesh=)``); every rank draws the
    same initial weights and reads the same metrics, so all take the same
    steps.  Rank 0 alone writes the files (the split ids, ``model_best_{i}.pt``
    from the gathered head, the HF folds and ``test_results.pkl``) and
    evaluates, unsharded; the other ranks return None."""
    if mesh is not None:
        from sequoia_tpu_torch.parallel.multihost import GlobalMesh

        if not isinstance(mesh, GlobalMesh):
            raise TypeError("run_cross_validation(mesh=) takes a multihost.GlobalMesh (one "
                            f"rank per device), got {type(mesh).__name__}")
        device = mesh.device
    lead = mesh is None or mesh.rank == 0
    if hf_export and model_type != "vis":
        raise ValueError("hf_export supports model_type='vis' here (the reference's ViT has "
                         "no hub mixin); HE2RNA exports via "
                         "run_he2rna_cross_validation(hf_export=True)")
    dev = resolve_device(device)
    os.makedirs(save_dir, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    # one block per dtype: read_csv leaves a block per column, and each
    # fold's row and column selections over 20,820 gene columns would then
    # cost seconds of host time
    df = df.copy()

    train_idxs, val_idxs, test_idxs = sp.patient_kfold(df["patient_id"].to_numpy(), n_splits=k)

    test_results_splits: dict = {}
    for i, (train_idx, val_idx, test_idx) in enumerate(zip(train_idxs, val_idxs, test_idxs)):
        train_df, val_df, test_df = df.iloc[train_idx], df.iloc[val_idx], df.iloc[test_idx]
        for name, part in (("train", train_df), ("val", val_df), ("test", test_df)):
            if lead:
                np.save(os.path.join(save_dir, f"{name}_{i}.npy"),
                        np.unique(part["patient_id"]))

        train_ds = ds.FeatureDataset(train_df, feature_path)
        val_ds = ds.FeatureDataset(val_df, feature_path)
        test_ds = ds.FeatureDataset(test_df, feature_path)
        num_outputs, feature_dim = train_ds.num_genes, train_ds.feature_dim
        num_clusters = getattr(train_ds, "num_tokens", None) or 100
        build = functools.partial(build_model, model_type, feature_dim=feature_dim,
                                  gen=gen, depth=depth, num_heads=num_heads,
                                  num_clusters=num_clusters, compute_dtype=compute_dtype)

        if checkpoint_path and change_num_genes:
            # GTEx -> TCGA: build at the pretraining width, load, swap the head
            cfg, _, _, to_torch, from_torch = build(change_num_genes)
            cfg, params = from_torch(checkpoint.load_torch_checkpoint(checkpoint_path), cfg)
            cfg, params = _MODELS[model_type].replace_head(cfg, tree_to(params, dev),
                                                           num_outputs, gen)
            apply_fn = _apply_fn(model_type, cfg)
        else:
            cfg, params, apply_fn, to_torch, from_torch = build(num_outputs)
            if checkpoint_path:
                sd = checkpoint.load_torch_checkpoint(_fold_checkpoint(checkpoint_path, i))
                cfg, params = from_torch(sd, cfg)

        loaders = {"train": ds.BatchLoader(train_ds, batch_size, shuffle=True, seed=seed),
                   "val": ds.BatchLoader(val_ds, batch_size, shuffle=False)}
        save_path = os.path.join(save_dir, f"model_best_{i}.pt")

        if do_train:
            result = loop.train(
                apply_fn, params,
                functools.partial(loop.make_adamw, lr=lr, moment_dtype=moment_dtype),
                loaders, num_epochs=num_epochs, patience=20, delta=0.5,
                save_on=save_on, stop_on=stop_on, verbose=verbose, log_fn=log_fn,
                state_path=(os.path.join(save_dir, f"train_state_{i}.npz") if resume else None),
                h2d_dtype=compute_dtype, device=dev, mesh=mesh,
                head_input_fn=apply_fn.head_input,
                save_fn=lambda p: checkpoint.save_torch_state_dict(to_torch(cfg, p), save_path))
            params = result.final_params if eval_on == "final" else result.params

        if not lead:
            # the random null's draw keeps this rank's generator in step with rank 0's
            build(num_outputs)
            continue
        if hf_export:
            # the reference's released checkpoints are the best-val weights,
            # which under eval_on='final' differ from the params in memory
            if os.path.exists(save_path):
                _, best = from_torch(checkpoint.load_torch_checkpoint(save_path), cfg)
            elif do_train:
                raise FileNotFoundError(f"hf_export: {save_path} missing after training — "
                                        "nothing to publish")
            else:
                best = params  # an inference-only run: the loaded weights
            checkpoint.save_hf_vis_layout(os.path.join(save_dir, f"hf_fold_{i}"), cfg, best)

        test_loader = ds.BatchLoader(test_ds, batch_size, shuffle=False)
        preds, real, wsis, projs = loop.evaluate(apply_fn, params, test_loader,
                                                 verbose=verbose, device=dev)

        # the untrained-model significance null (reference main.py:194-204)
        _, rand_params, rand_apply, _, _ = build(num_outputs)
        random_preds, _, _, _ = loop.evaluate(rand_apply, rand_params, test_loader,
                                              verbose=verbose, device=dev)
        del rand_params

        test_results_splits[f"split_{i}"] = {
            "real": real, "preds": preds, "random": random_preds,
            "wsi_file_name": wsis, "tcga_project": projs,
        }

    if not lead:
        return None
    test_results_splits["genes"] = ds.gene_names(df)
    with open(os.path.join(save_dir, "test_results.pkl"), "wb") as f:
        pickle.dump(test_results_splits, f, protocol=pickle.HIGHEST_PROTOCOL)
    return test_results_splits


def run_he2rna_cross_validation(
        df, feature_path: str, save_dir: str, *, k: int = 5, batch_size: int = 16,
        lr: float = 1e-3, max_epochs: int = 200, seed: int = 99,
        checkpoint_path: str | None = None, change_num_genes: bool = False,
        num_genes: int | None = None, log_fn=None, verbose: bool = True,
        hf_export: bool = False, device=None) -> dict:
    """The reference ``src/he2rna.py`` __main__ CV on ``device`` (cuda unless
    asked otherwise): per fold, the random null (the untrained or loaded
    model's predictions) before the fit, then ``he2rna_fit.fit`` writing
    ``model_{i}.pt``, the test fold's predictions of its best model, and with
    ``hf_export`` the saved model as ``hf_fold_{i}/``.

    ``checkpoint_path``: one ``.pt`` whose architecture (and ``__ks__``) the
    fold models take; ``change_num_genes`` then swaps its head for one of
    this cohort's width.  Without a checkpoint, ``change_num_genes`` with
    ``num_genes`` builds the head at ``num_genes`` and swaps it, as the
    reference does."""
    dev = resolve_device(device)
    os.makedirs(save_dir, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    df = df.copy()  # one block per dtype, as in run_cross_validation

    train_idxs, val_idxs, test_idxs = sp.patient_kfold(df["patient_id"].to_numpy(), n_splits=k)

    test_results_splits: dict = {}
    for i, (train_idx, val_idx, test_idx) in enumerate(zip(train_idxs, val_idxs, test_idxs)):
        train_ds = ds.FeatureDataset(df.iloc[train_idx], feature_path)
        val_ds = ds.FeatureDataset(df.iloc[val_idx], feature_path)
        test_ds = ds.FeatureDataset(df.iloc[test_idx], feature_path)

        out_dim = num_genes if change_num_genes and num_genes else train_ds.num_genes
        cfg = he2rna.HE2RNAConfig(
            input_dim=train_ds.feature_dim, output_dim=out_dim, layers=(256, 256),
            ks=he2rna.ks_for_tokens(getattr(train_ds, "num_tokens", None)))
        params = he2rna.init(cfg, gen)
        if checkpoint_path:
            # the architecture (and a pickled module's ks) from the state dict
            cfg, params = convert.he2rna_from_torch(
                checkpoint.load_torch_checkpoint(checkpoint_path))
            params = tree_to(params, dev)
        if change_num_genes:
            cfg, params = he2rna.replace_head(cfg, params, train_ds.num_genes, gen)

        test_loader = ds.BatchLoader(test_ds, batch_size, shuffle=False)
        # the random null before the fit (reference he2rna.py:411)
        preds_random, _, _, _ = he2rna_fit.he2rna_predict(cfg, params, test_loader, device=dev)

        save_path = os.path.join(save_dir, f"model_{i}.pt")
        preds, labels, wsis, projs = he2rna_fit.fit(
            cfg, params, lr, ds.BatchLoader(train_ds, batch_size, shuffle=True, seed=seed),
            ds.BatchLoader(val_ds, batch_size, shuffle=False), test_loader,
            max_epochs=max_epochs, patience=100, seed=seed, log_fn=log_fn, verbose=verbose,
            device=dev,
            save_fn=lambda p, c=cfg, path=save_path: checkpoint.save_torch_state_dict(
                convert.he2rna_to_torch(c, p), path))
        del params
        if hf_export:
            if not os.path.exists(save_path):
                raise FileNotFoundError(f"hf_export: {save_path} missing — fit() saved no "
                                        "model; refusing to publish untrained init weights")
            _, best = convert.he2rna_from_torch(checkpoint.load_torch_checkpoint(save_path))
            checkpoint.save_hf_he2rna_layout(os.path.join(save_dir, f"hf_fold_{i}"), cfg, best)

        test_results_splits[f"split_{i}"] = {
            "real": labels, "preds": preds, "random": preds_random,
            "wsi_file_name": wsis, "tcga_project": projs,
        }

    test_results_splits["genes"] = ds.gene_names(df)
    with open(os.path.join(save_dir, "test_results.pkl"), "wb") as f:
        pickle.dump(test_results_splits, f, protocol=pickle.HIGHEST_PROTOCOL)
    return test_results_splits
