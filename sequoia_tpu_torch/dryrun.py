"""Entry points: the production ViS forward (``entry``) and the
multi-device dry run, one sharded ViS AdamW step, one sharded inference step
and one sharded window stage over an (n_data, n_model) mesh.

Counterpart of ``__graft_entry__.entry`` (``:18``) and
``__graft_entry__.dryrun_multichip`` (``:76``) with its inference
(``_dryrun_infer``, ``:159``) and spatial (``_dryrun_spatial``, ``:250``)
legs::

    python -m sequoia_tpu_torch.dryrun    # entry()'s forward, then every card
    python -c "from sequoia_tpu_torch import dryrun; dryrun.dryrun_multichip(4)"

``entry(device=None)`` returns ``(forward, (params, features))``: the plain
``vis.apply`` in f32 at the production config (:func:`entry_config`: D =
2048, depth 6, 16 heads of 64, 100 cluster tokens, 20,820 genes), weights
from ``vis.init`` with a generator seeded 0, and a (16, 100, 2048) f32
batch from ``np.random.default_rng(0)``, on CUDA unless ``device="cpu"``.
Like JAX's ``entry``, it runs no kernel.

``production`` (the default, or ``SEQUOIA_DRYRUN_FULL=1``): the full shapes,
D = 2048, depth 6, 16 heads and the 20,820-gene head; ``SEQUOIA_DRYRUN_FULL=0``
gives a tiny wiring check.  The model degree is 2 where n is even and 1
otherwise; ``SEQUOIA_DRYRUN_MODEL`` sets it (it must divide n).

The training leg runs over n spawned ranks (``multihost.spawn_local``; NCCL
over n CUDA devices, gloo over n CPU processes with ``device="cpu"``); the
inference and spatial legs run in this process over an in-process
``sharding.Mesh`` (the CPU repeated n times with ``device="cpu"``, as JAX's
virtual CPU devices).  Each leg asserts that every rank or device holds
1/n_model of each fold's (D, G) head and, in training, of its AdamW moments.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def entry_config(input_dim: int = 2048, num_outputs: int = 20820, depth: int = 6,
                 nheads: int = 16, head_dim: int = 64, num_clusters: int = 100):
    """The ViS config of :func:`entry`; the defaults are the production
    widths, and the tests call it at a small width."""
    from sequoia_tpu_torch.models import vis

    return vis.ViSConfig(num_outputs=num_outputs, input_dim=input_dim, depth=depth,
                         nheads=nheads, dim_f=head_dim, dim_s=head_dim, dim_c=head_dim,
                         num_clusters=num_clusters)


def entry(device=None):
    """``(forward, (params, features))``: ``forward(params, features)`` is
    ``vis.apply`` at :func:`entry_config`, the params
    ``vis.init`` with a generator seeded 0, the features a (16, T, D) f32
    draw of ``np.random.default_rng(0).normal``; on ``device`` (CUDA unless
    given; raises without it)."""
    from sequoia_tpu_torch.models import vis
    from sequoia_tpu_torch.utils.device import resolve_device, tree_to

    dev = resolve_device(device)
    cfg = entry_config()
    params = tree_to(vis.init(cfg, torch.Generator().manual_seed(0)), dev)

    def forward(params, features):
        return vis.apply(cfg, params, features)

    features = torch.from_numpy(np.random.default_rng(0).normal(
        size=(16, cfg.num_clusters, cfg.input_dim)).astype(np.float32)).to(dev)
    return forward, (params, features)


def _factor(n_devices: int) -> tuple[int, int]:
    n_model = int(os.environ.get("SEQUOIA_DRYRUN_MODEL", "0")) or (
        2 if n_devices % 2 == 0 and n_devices > 1 else 1)
    if n_model < 1 or n_devices % n_model:
        raise ValueError(f"model degree {n_model} must divide {n_devices}")
    return n_devices // n_model, n_model


def _vis_cfg(production: bool, n_model: int, D: int | None = None, k: int = 100):
    from sequoia_tpu_torch.models import vis

    if production:
        return entry_config(input_dim=D or 2048, num_clusters=k)
    return vis.ViSConfig(num_outputs=32 * n_model, input_dim=D or 64, depth=2, nheads=4,
                         dim_f=8, dim_s=8, dim_c=8, num_clusters=k)


def _train_leg(n_model: int, production: bool, device_type: str) -> dict:
    """One rank of the training leg: the sharded step on a global batch of
    2 rows per data row; returns the loss and this rank's byte counts."""
    from sequoia_tpu_torch.models import vis
    from sequoia_tpu_torch.parallel import multihost as mh
    from sequoia_tpu_torch.parallel import sharding as sh
    from sequoia_tpu_torch.train import loop

    mesh = mh.make_global_mesh(n_model=n_model, device=mh.rank_device(
        "cpu" if device_type == "cpu" else None))
    cfg = _vis_cfg(production, n_model)
    n_data = mesh.shape["data"]
    B, T, D, G = 2 * n_data, 100, cfg.input_dim, cfg.num_outputs
    full = vis.init(cfg, torch.Generator().manual_seed(0))
    params = loop.tree_map(lambda t: t.requires_grad_(True), sh.shard_params(mesh, full))
    del full
    opt = loop.make_adamw(params, lr=1e-3)
    step, _ = loop.make_sharded_step_fns(lambda p, x: vis.apply(cfg, p, x), opt, mesh,
                                         lambda p, x: vis.head_input(cfg, p, x))
    rng = np.random.default_rng(0)
    feats, rna, valid = sh.shard_batch_arrays(
        mesh, torch.from_numpy(rng.normal(size=(B, T, D)).astype(np.float32)),
        torch.from_numpy(rng.normal(size=(B, G)).astype(np.float32)),
        torch.ones((B,), dtype=torch.bool))
    loss = float(step(params, feats, rna, valid)["loss"])
    assert np.isfinite(loss), f"non-finite loss {loss}"
    full_bytes = 4 * D * G
    head = params["head_w"].numel() * params["head_w"].element_size()
    moments = [opt.state[params["head_w"]][k] for k in ("exp_avg", "exp_avg_sq")]
    assert head * n_model == full_bytes, (head, full_bytes)
    for m in moments:
        assert m.numel() * m.element_size() * n_model == full_bytes, \
            "AdamW moments of the gene head are not sharded with the param"
    return {"loss": loss, "head_bytes": head, "D": D, "G": G}


def _mesh(n_devices: int, n_data: int, n_model: int, device_type: str):
    from sequoia_tpu_torch.parallel import sharding as sh

    if device_type == "cpu":
        devices = [torch.device("cpu")] * n_devices
    else:
        devices = sh.local_devices("cuda")
        if len(devices) < n_devices:
            raise RuntimeError(f"need {n_devices} CUDA devices, found {len(devices)}; pass "
                               "device='cpu' to run the legs on the CPU")
    return sh.make_mesh(n_data=n_data, n_model=n_model, devices=devices[:n_devices])


def _assert_heads(cells, n_model: int, D: int, G: int, folds: int) -> int:
    """Every cell holds 1/n_model of each fold's head; returns one cell's
    head bytes over all folds."""
    per_cell = None
    for row in cells:
        for cell in row:
            b = sum(p["head_w"].numel() * p["head_w"].element_size() for p in cell.values())
            assert b * n_model == 4 * folds * D * G, (b, n_model, D, G)
            per_cell = b
    return per_cell


def _infer_leg(mesh, n_data: int, n_model: int, production: bool) -> str:
    """Patches over ``data`` through the ResNet (``FeatureExtractor(mesh=)``),
    k-means on the first device, then the fold ensemble with each fold's
    head over ``model`` (``spatial.make_vis_stacked_predict_fn`` on the
    mesh's first row: one slide's cluster features are one example)."""
    from sequoia_tpu_torch.models import resnet
    from sequoia_tpu_torch.ops import kmeans as km
    from sequoia_tpu_torch.parallel import sharding as sh
    from sequoia_tpu_torch.pipeline.features import FeatureExtractor
    from sequoia_tpu_torch.pipeline.spatial import make_vis_stacked_predict_fn

    if production:
        patch, n_patches, k, folds = 256, 16 * n_data, 100, 5
        while n_patches < k:
            n_patches += n_data
    else:
        patch, n_patches, k, folds = 64, 4 * n_data, 4, 2
    ext = FeatureExtractor("resnet", resnet.random_params(torch.Generator().manual_seed(0)),
                           batch_size=n_patches, cfg=resnet.ResNetConfig(), patch_size=patch,
                           mesh=mesh)
    D = ext.feature_dim
    vcfg = _vis_cfg(production, n_model, D=D, k=k)
    G = vcfg.num_outputs
    ensemble = make_vis_stacked_predict_fn(
        vcfg, {f: _vis_init(vcfg, f) for f in range(folds)},
        mesh=sh.Mesh((mesh.devices[0],)))
    rng = np.random.default_rng(7)
    u8 = ext.upload(rng.integers(0, 256, (n_patches, patch, patch, 3), dtype=np.uint8))
    with torch.no_grad():
        feats = ext.raw_fwd(ext.params, u8)  # (N, D) on the first device
        mask = torch.ones((n_patches,), dtype=torch.bool, device=mesh.first)
        gen = torch.Generator(device=mesh.first).manual_seed(0)
        _, labels, _, _ = km.kmeans_fit(feats, mask, gen, n_clusters=k)
        cf = km.cluster_means(feats, labels, mask, k)[None]
        pred = ensemble.raw_fwd(cf).mean(0)[0]  # the fold-ensemble average
    assert pred.shape == (G,) and bool(torch.isfinite(pred).all()), pred.shape
    shard = _assert_heads(ensemble.raw_fwd.cells, n_model, D, G, folds)
    return (f"dryrun_multichip infer: {n_patches} patches({patch}px) -> resnet50 -> "
            f"kmeans{k} -> ViS x{folds} folds ensemble [G={G}, head shard "
            f"{shard / 2**20:.1f} MiB/device] infer leg OK")


def _vis_init(cfg, seed: int):
    from sequoia_tpu_torch.models import vis

    return vis.init(cfg, torch.Generator().manual_seed(seed))


def _spatial_leg(mesh, n_data: int, n_model: int, production: bool) -> str:
    """``spatial.sliding_window_predict_arrays(mesh=)`` over a grid of
    tiles: windows over ``data``, fold heads over ``model``, the overlap
    sums and counts on the first device."""
    import pandas as pd

    from sequoia_tpu_torch.pipeline import spatial

    if production:  # 16 x 16 tiles, four windows of 64-100 tiles
        nx, ny, D, K, folds, window, stride = 16, 16, 2048, 100, 5, 10, 8
    else:  # 8 x 4 tiles, three windows of 16
        nx, ny, D, K, folds, window, stride = 8, 4, 64, 8, 2, 4, 2
    n = nx * ny
    vcfg = _vis_cfg(production, n_model, D=D, k=K)
    G = vcfg.num_outputs
    multi = spatial.make_vis_stacked_predict_fn(
        vcfg, {f: _vis_init(vcfg, f) for f in range(folds)}, mesh=mesh)
    rng = np.random.default_rng(11)
    tiles = rng.normal(size=(n, D)).astype(np.float32)
    x, y = np.divmod(np.arange(n), ny)
    df = pd.DataFrame({"xcoord_tf": x, "ycoord_tf": y})
    W = len(spatial.collect_windows(df, stride=stride, window=window))
    folds_out, maps, seen = spatial.sliding_window_predict_arrays(
        tiles, df, multi, range(G), stride=stride, window=window, num_tokens=K,
        batch_windows=n_data, accumulate="device", mesh=mesh)
    assert list(folds_out) == list(range(folds)) and seen.any()
    for f in folds_out:
        assert maps[f].shape == (n, G) and bool(np.isfinite(maps[f][seen]).all())
    shard = _assert_heads(multi.raw_fwd.cells, n_model, D, G, folds)
    return (f"dryrun_multichip spatial: {W} windows x {K} tokens over {n} tiles -> ViS x"
            f"{folds} folds [G={G}, head shard {shard / 2**20:.1f} MiB/device] "
            "spatial leg OK")


def dryrun_multichip(n_devices: int, production: bool | None = None,
                     device: str | None = None) -> list[str]:
    """The three legs over n devices; returns their report lines (also
    printed).  ``device``: None for CUDA (n devices needed), ``"cpu"`` for
    the CPU."""
    from sequoia_tpu_torch.parallel import multihost as mh

    if production is None:
        production = os.environ.get("SEQUOIA_DRYRUN_FULL", "1") != "0"
    device_type = "cpu" if device == "cpu" else "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip runs on CUDA unless device='cpu'")
    n_data, n_model = _factor(n_devices)
    mesh = _mesh(n_devices, n_data, n_model, device_type)  # refuses a short host early
    backend = "gloo" if device_type == "cpu" else mh.default_backend()
    ranks = mh.spawn_local(_train_leg, n_devices, (n_model, production, device_type),
                           backend=backend, timeout=3600.0,
                           devices=None if device_type == "cpu"
                           else [f"cuda:{r}" for r in range(n_devices)])
    losses = {r["loss"] for r in ranks}
    assert len(losses) == 1, f"ranks disagree on the loss: {losses}"
    r0 = ranks[0]
    lines = [f"dryrun_multichip({n_devices}): mesh data={n_data} model={n_model} "
             f"[{'production' if production else 'tiny'} shapes: D={r0['D']} G={r0['G']}] "
             f"loss={r0['loss']:.4f} head shard {r0['head_bytes'] / 2**20:.1f} MiB/device "
             "train leg OK",
             _infer_leg(mesh, n_data, n_model, production),
             _spatial_leg(mesh, n_data, n_model, production)]
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    from sequoia_tpu_torch.ops.nn import precision

    precision()  # TF32 off: the f32 forward is IEEE f32
    fn, args = entry()
    with torch.no_grad():
        out = fn(*args)
    assert out.shape == (16, 20820) and bool(torch.isfinite(out).all()), tuple(out.shape)
    print(f"entry: forward {tuple(out.shape)} finite")
    dryrun_multichip(torch.cuda.device_count())
