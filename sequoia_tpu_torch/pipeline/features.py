"""Stage 2, feature extraction: patches HDF5 -> per-patch embeddings, and
the batched backbone with fused preprocessing that serving shares.

Counterpart of ``sequoia_tpu/pipeline/features.py``. Patches travel to the
device as uint8 in fixed ``batch_size`` blocks, the tail block zero-padded
to the full batch; the preprocessing runs on the device with the backbone
(the ImageNet normalization, and for the ViTs first the bit-exact Pillow
resize to 224: bilinear for UNI, bicubic for Virchow2). ``raw_fwd`` is the
backbone as one ``(params, u8) -> (N, D)`` function honouring ``cfg``, so a
caller can run more device work on the same uploaded batch (serving's tissue screen and raw-plane reconstruction,
``serve.SlidePredictor._fused_program`` and its siblings).

With ``mesh`` (an in-process ``parallel.sharding.Mesh``) extraction is data
parallel over the mesh's ``data`` rows: each row's first device holds a copy
of the parameters, a batch splits into equal row shards (``batch_size`` must
divide by the ``data`` axis, as in JAX), the shards are launched device by
device with no sync in between, and the features are gathered on the mesh's
first device.  The backbone mixes no examples, so no collective runs; the
kernels the config selects run on every device.

On-disk contract of the stage (reference
``pre_processing/compute_features_hdf5.py:99-139``):
``{feature_path}/{project}/{wsi}/{wsi}.h5`` holding ``{feat_type}_features``
(N, D) float32, then a ``complete_tile.txt`` sentinel; ``complete_resnet.txt``
is honoured as a skip marker too; a slide's patches are subsampled to
``max_patch_number`` with ``random.sample`` from one ``random.Random(seed)``
for the whole ref file; a slide that fails is reported and skipped.  h5py is
imported inside the functions that read or write it.
"""

from __future__ import annotations

import contextlib
import os
import random as pyrandom

import numpy as np
import torch

from sequoia_tpu_torch.models import resnet as resnet_mod
from sequoia_tpu_torch.models import uni_vit
from sequoia_tpu_torch.ops.nn import precision
from sequoia_tpu_torch.utils.device import resolve_device, tree_to
from sequoia_tpu_torch.utils.profiling import span


#: the backbones a ``feat_type`` names
FEAT_TYPES = ("resnet", "uni", "virchow2")


def vit_config(feat_type: str, **kw) -> uni_vit.UniViTConfig:
    """The default config of the ViT backbone ``feat_type`` (``"uni"`` or
    ``"virchow2"``, ``models/uni_vit.py``), with ``kw`` set on it."""
    return (uni_vit.UniViTConfig if feat_type == "uni" else uni_vit.Virchow2Config)(**kw)


class FeatureExtractor:
    """uint8 patches -> backbone features.

    ``feat_type="resnet"``: normalize 256-px patches -> ResNet-50 -> 2048-d;
    ``cfg.early_pallas`` / ``fused_stages`` switch the ResNet kernels on.
    ``feat_type="uni"``: resize to 224 (bit-exact Pillow BILINEAR, the
    reference's PIL ``Resize(224)``) -> ViT-L/16 -> the CLS token, 1024-d.
    ``feat_type="virchow2"``: resize to 224 (bit-exact Pillow BICUBIC, the
    model card's transform) -> ViT-H/14 with 4 registers and a packed SwiGLU
    MLP -> CLS ⊕ the patch tokens' mean, 2560-d; it has no JAX counterpart.
    A ViT's weights are cast to the compute dtype once here.  ``params``:
    the port's parameters for that backbone (moved to ``device``, or to
    every ``data`` row of ``mesh``, whose first device is then the
    extractor's).  The compute dtype comes from ``cfg`` or
    ``compute_dtype`` (f32 by default)."""

    def __init__(self, feat_type: str, params, batch_size: int = 256,
                 compute_dtype=None, patch_size: int = 256, cfg=None, mesh=None,
                 device=None):
        if feat_type not in FEAT_TYPES:
            raise ValueError(f"feat_type must be one of {FEAT_TYPES}, got {feat_type!r}")
        if mesh is not None:
            from sequoia_tpu_torch.parallel.sharding import in_process

            in_process(mesh, "FeatureExtractor(mesh=)")
            if batch_size % mesh.shape["data"]:
                raise ValueError(f"batch_size {batch_size} not divisible by mesh data axis "
                                 f"{mesh.shape['data']}")
            if device is not None and torch.device(device) != mesh.first:
                raise ValueError(f"device {device} is not the mesh's first device {mesh.first}")
            device = mesh.first
        if (cfg is not None and compute_dtype is not None
                and precision(cfg.compute_dtype) != precision(compute_dtype)):
            raise ValueError(f"cfg.compute_dtype={cfg.compute_dtype} conflicts with "
                             f"compute_dtype={compute_dtype}; set it on the cfg")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.feat_type = feat_type
        self.batch_size = batch_size
        self.patch_size = patch_size
        dt = precision(compute_dtype if cfg is None else cfg.compute_dtype)
        if feat_type == "resnet":
            self.cfg = cfg or resnet_mod.ResNetConfig(compute_dtype=dt)
            self.feature_dim = self.cfg.feature_dim_for(patch_size, patch_size)

            def place(d):
                return tree_to(params, d)
        else:
            self.cfg = cfg or vit_config(feat_type, compute_dtype=dt)
            self.feature_dim = self.cfg.feature_dim

            def place(d):
                return uni_vit.prepare(self.cfg, tree_to(params, d))
        self.params = place(self.device)
        # the other data rows' copies (row 0 computes with the params it is given)
        self._replicas = [place(row[0]) for row in mesh.devices[1:]] if mesh else []

    def upload(self, block_u8: np.ndarray) -> torch.Tensor:
        """Host block -> the extractor's device (the span ``serve.upload``)."""
        with span("serve.upload", bytes=block_u8.nbytes):
            return torch.as_tensor(block_u8).to(self.device, non_blocking=True)

    def map_shards(self, fn, params, *xs: torch.Tensor):
        """``fn(params, *rows)`` over the ``data`` row shards of each of
        ``xs`` (a batch and its per-row companions, split alike; each shard
        on its row's device, with its copy of the parameters; row 0 with
        ``params``), the results (a tensor or a tuple of them) concatenated
        on the first device.  Without a mesh, ``fn(params, *xs)``."""
        if self.mesh is None:
            return fn(params, *xs)
        from sequoia_tpu_torch.parallel.sharding import dp_images

        outs = []
        for i, rows in enumerate(zip(*(dp_images(self.mesh, x) for x in xs))):
            with _on(rows[0].device):  # the kernels launch on the current device's stream
                outs.append(fn(params if i == 0 else self._replicas[i - 1], *rows))
        first = self.mesh.first
        if isinstance(outs[0], tuple):
            return tuple(torch.cat([o[k].to(first, non_blocking=True) for o in outs])
                         for k in range(len(outs[0])))
        return torch.cat([o.to(first, non_blocking=True) for o in outs])

    def raw_fwd(self, params, u8: torch.Tensor) -> torch.Tensor:
        """(N, ps, ps, 3) uint8 on the device -> (N, D) f32 features through
        ``cfg`` (its kernel options included).  Under a mesh, data parallel
        (:meth:`map_shards`)."""
        if self.mesh is not None:
            return self.map_shards(self._one_fwd, params, u8)
        return self._one_fwd(params, u8)

    def _one_fwd(self, params, u8: torch.Tensor) -> torch.Tensor:
        if self.feat_type == "resnet":
            return resnet_mod.extract_from_uint8(self.cfg, params, u8)
        return uni_vit.extract_from_uint8(self.cfg, params, u8)

    @torch.no_grad()
    def features(self, patches_u8) -> torch.Tensor:
        """(N, ps, ps, 3) uint8 (numpy or tensor) -> (N, D) f32 on the
        device, in ``batch_size`` blocks with the tail padded; each block's
        backbone is the span ``serve.backbone``."""
        n, bs = patches_u8.shape[0], self.batch_size
        out = torch.empty((n, self.feature_dim), dtype=torch.float32, device=self.device)
        for start in range(0, n, bs):
            block = patches_u8[start:start + bs]
            if not isinstance(block, torch.Tensor):
                block = self.upload(np.ascontiguousarray(block))
            m = block.shape[0]
            with span("serve.backbone", patches=m):
                block = block.to(self.device)
                if m < bs:  # pad the tail to the full batch shape
                    pad = torch.zeros((bs - m,) + tuple(block.shape[1:]), dtype=block.dtype,
                                      device=block.device)
                    block = torch.cat([block, pad])
                feats = self.raw_fwd(self.params, block)
                out[start:start + m] = feats[:m]
        return out

    def __call__(self, patches_u8) -> np.ndarray:
        """(N, ps, ps, 3) uint8 -> (N, D) f32 numpy."""
        return self.features(patches_u8).cpu().numpy()


def _on(dev: torch.device):
    """``dev`` as the current CUDA device (nothing for the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def load_patches(patch_h5_path: str, max_patch_number: int | None,
                 rng: pyrandom.Random) -> np.ndarray:
    """A slide's patches (N, ps, ps, 3) uint8 from either layout, subsampled
    to ``max_patch_number`` with ``rng.sample`` over the tile names in h5py's
    order.  The packed layout rebuilds that order from ``coords``, so a seed
    selects the same patches, in the same order, from both layouts."""
    import h5py

    with h5py.File(patch_h5_path, "r") as f:
        if "patches" in f:  # packed layout: one bulk read
            coords = f["coords"][:]
            names = [f"{x}_{y}" for x, y in coords]
            row_of = {nm: i for i, nm in enumerate(names)}
            keys = sorted(names)  # h5py lists names byte-wise sorted
            if max_patch_number is not None and len(keys) > max_patch_number:
                keys = rng.sample(keys, max_patch_number)
            rows = np.asarray([row_of[nm] for nm in keys])
            order = np.argsort(rows)  # h5py fancy indexing wants increasing rows
            return f["patches"][rows[order]][np.argsort(order)]
        keys = list(f.keys())
        if max_patch_number is not None and len(keys) > max_patch_number:
            keys = rng.sample(keys, max_patch_number)
        return np.stack([f[k][:] for k in keys])


def compute_features(df, patch_data_path: str, feature_path: str,
                     extractor: FeatureExtractor, *, max_patch_number: int = 4000,
                     seed: int = 99, verbose: bool = True, timer=None) -> int:
    """The reference's feature stage over a ref-file DataFrame (duplicate
    ``wsi_file_name`` rows dropped).  Returns the number of slides written.
    ``timer``: a ``utils.profiling.StageTimer`` to accumulate the
    ``read_patches`` / ``extract`` / ``write_features`` stages into."""
    import h5py

    from sequoia_tpu_torch.utils.profiling import StageTimer

    timer = timer or StageTimer()
    rng = pyrandom.Random(seed)  # one stream for the whole ref file, as the reference
    df = df.drop_duplicates(["wsi_file_name"])
    done = 0
    for _, row in df.iterrows():
        wsi = str(row["wsi_file_name"])
        wsi_slide = wsi.split(".")[0]
        project = row.get("tcga_project", "")
        wsi = wsi.replace(".svs", "")

        patch_dir = os.path.join(patch_data_path, wsi_slide)
        if not os.path.exists(patch_dir):
            if verbose:
                print(f"Not exist {patch_dir}")
            continue
        path = os.path.join(patch_dir, wsi_slide + ".hdf5")
        path_h5 = os.path.join(feature_path, str(project), wsi)
        os.makedirs(path_h5, exist_ok=True)
        if (os.path.exists(os.path.join(path_h5, "complete_resnet.txt"))
                or os.path.exists(os.path.join(path_h5, "complete_tile.txt"))):
            if verbose:
                print(f"{wsi}: features already obtained")
            continue

        try:
            with timer.stage("read_patches", items=1):
                patches = load_patches(path, max_patch_number, rng)
            with timer.stage("extract", items=len(patches)):
                feats = extractor(patches)
            with timer.stage("write_features", items=1):
                with h5py.File(os.path.join(path_h5, wsi + ".h5"), "w") as fw:
                    fw.create_dataset(f"{extractor.feat_type}_features", data=feats)
            with open(os.path.join(path_h5, "complete_tile.txt"), "w") as fs:
                fs.write(f"Total n patch = {len(feats)}")
            done += 1
        except Exception as e:  # per-slide quarantine (reference behaviour)
            print(f"{wsi}: {e}")
    if verbose and done:
        print(timer.report())
        print(f"slides/hour (feature stage): {timer.slides_per_hour():.1f}")
    return done
