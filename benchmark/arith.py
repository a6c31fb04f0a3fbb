"""The yardstick's arithmetic: peaks of one H100 SXM, and the operations and
bytes of each layer's work, counted from the model's shapes whatever
implements it.

Peaks are NVIDIA's data sheet for the SXM part (dense rates, 700 W).  The
ViS training count is a copy of ``sequoia_tpu_torch/bench._vis_train_flops``;
the roofline rule (the least time is the larger of operations over the peak
and bytes over the bandwidth, each input and output byte counted once) is
``chip_smoke.py``'s kernel-bound rule.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(flops_by_dtype: dict, nbytes: float) -> float:
    """The least time the card could take for this work: the larger of the
    compute time (each dtype's operations over its peak) and the bytes over
    the memory bandwidth."""
    compute = sum(f / PEAK_FLOPS[dt] for dt, f in flops_by_dtype.items())
    return max(compute, nbytes / PEAK_BYTES_PER_S)


# ---------------------------------------------------------------- ResNet-50

RESNET50_STAGES = ((64, 3), (128, 4), (256, 6), (512, 3))  # (width, blocks)


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def resnet50_macs(h: int, w: int, fc_classes: int = 0) -> int:
    """Multiply-accumulates of one ResNet-50 forward on an (h, w) image:
    every convolution (torchvision layout, stride on the 3x3), plus a
    ``fc_classes``-wide classifier where asked (the backbone has none)."""
    macs = 0
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    macs += h * w * 64 * 3 * 49
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    cin = 64
    for s, (width, blocks) in enumerate(RESNET50_STAGES):
        cout = width * 4
        for b in range(blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            ho, wo = _out(h, 3, stride, 1), _out(w, 3, stride, 1)
            macs += h * w * cin * width            # 1x1 reduce
            macs += ho * wo * width * width * 9    # 3x3 (strided)
            macs += ho * wo * width * cout         # 1x1 expand
            if b == 0:
                macs += ho * wo * cin * cout       # projection shortcut
            h, w, cin = ho, wo, cout
    return macs + 2048 * fc_classes


def resnet50_params(fc_classes: int = 0) -> int:
    """Weights of the backbone's convolutions (the folded BN's scale and
    bias, 2 per channel, included)."""
    n = 64 * 3 * 49 + 2 * 64
    cin = 64
    for s, (width, blocks) in enumerate(RESNET50_STAGES):
        cout = width * 4
        for b in range(blocks):
            n += cin * width + width * width * 9 + width * cout + 2 * (2 * width + cout)
            if b == 0:
                n += cin * cout + 2 * cout
            cin = cout
    return n + (2048 + 1) * fc_classes


def resnet50_work(n_patches: int, size: int, batch: int, dtype: str) -> tuple[dict, float]:
    """(flops by dtype, bytes) of the backbone over ``n_patches`` uint8
    patches of ``size`` px in batches of ``batch`` (the tail padded, as the
    extractor runs it): the uint8 in, the f32 features out, the weights once
    a batch."""
    n_run = -(-n_patches // batch) * batch
    flops = 2.0 * resnet50_macs(size, size) * n_run
    nbytes = (n_patches * size * size * 3 + n_patches * 2048 * 4
              + (n_run // batch) * resnet50_params() * BYTES[dtype])
    return {dtype: flops}, float(nbytes)


# ---------------------------------------------------------------- ViT-L/16

def vit_macs(img: int = 224, patch: int = 16, dim: int = 1024, depth: int = 24,
             mlp: int = 4096) -> int:
    """Multiply-accumulates of one ViT forward (patch embed, then per block
    qkv, q.k^T, attention x V, the output projection and the MLP)."""
    n = (img // patch) ** 2 + 1
    embed = (n - 1) * (patch * patch * 3) * dim
    block = n * dim * 3 * dim + 2 * n * n * dim + n * dim * dim + 2 * n * dim * mlp
    return embed + depth * block


def vit_params(img: int = 224, patch: int = 16, dim: int = 1024, depth: int = 24,
               mlp: int = 4096) -> int:
    n = (img // patch) ** 2 + 1
    block = 4 * dim * dim + 4 * dim + 2 * dim * mlp + mlp + dim + 6 * dim
    return patch * patch * 3 * dim + dim + dim + n * dim + depth * block + 2 * dim


def vit_work(n_patches: int, size: int, batch: int, dtype: str, **shape) -> tuple[dict, float]:
    """(flops by dtype, bytes) of the UNI backbone over ``n_patches`` uint8
    patches of ``size`` px (resized on the card) in batches of ``batch``."""
    n_run = -(-n_patches // batch) * batch
    flops = 2.0 * vit_macs(**shape) * n_run
    dim = shape.get("dim", 1024)
    nbytes = (n_patches * size * size * 3 + n_patches * dim * 4
              + (n_run // batch) * vit_params(**shape) * BYTES[dtype])
    return {dtype: flops}, float(nbytes)


# ---------------------------------------------------------------- ViS

def vis_forward_flops(tokens: int, dim: int, depth: int, heads: int, dim_f: int,
                      dim_s: int, dim_c: int, genes: int) -> tuple[float, float]:
    """(block flops, head flops) of one ViS forward of one slide."""
    t, d, h = tokens, dim, heads
    per_block = (2 * t * d * h * dim_f + 2 * t * d * h * dim_s
                 + 2 * t * h * (dim_f + dim_s) * dim_c + 2 * t * (h * dim_c) * d
                 + 4 * t * d * d)
    return float(depth * per_block), float(2 * d * genes)


def vis_params(dim: int, depth: int, heads: int, dim_f: int, dim_s: int, dim_c: int,
               genes: int, tokens: int) -> tuple[int, int]:
    """(block and embedding parameters, head parameters) of one fold."""
    d, h = dim, heads
    block = (d * h * dim_f + h * dim_f + d * h * dim_s + h * dim_s
             + h * (dim_f + dim_s) * dim_c + h * dim_c + 2 * h * (dim_f + dim_s)
             + h * dim_c * d + d + 2 * d + 2 * (d * d + d))
    return depth * block + tokens * d, d * genes + genes + 2 * d


def vis_folds_work(folds: int, tokens: int, dtype: str, **shape) -> tuple[dict, float]:
    """(flops by dtype, bytes) of ``folds`` ViS forwards of one slide's
    (tokens, dim) cluster features: the blocks in ``dtype``, LayerNorms and
    the gene head in f32 (the port's bf16 mode keeps them there)."""
    blocks, head = vis_forward_flops(tokens, **shape)
    pb, ph = vis_params(tokens=tokens, **shape)
    nbytes = folds * (pb * BYTES[dtype] + ph * 4) + tokens * shape["dim"] * 4 + shape["genes"] * 4
    if dtype == "float32":
        return {"float32": folds * (blocks + head)}, float(nbytes)
    return {dtype: folds * blocks, "float32": folds * head}, float(nbytes)


def vis_train_flops(tokens: int, dim: int, depth: int, heads: int, dim_f: int, dim_s: int,
                    dim_c: int, genes: int, batch: int) -> float:
    """Matmul flops of one ViS train step (forward + twice that backward);
    a copy of ``sequoia_tpu_torch/bench._vis_train_flops``."""
    t, d, h = tokens, dim, heads
    per_block = (2 * t * d * h * dim_f + 2 * t * d * h * dim_s
                 + 2 * t * h * (dim_f + dim_s) * dim_c + 2 * t * (h * dim_c) * d
                 + 4 * t * d * d)
    fwd = depth * per_block + 2 * d * genes
    return 3.0 * fwd * batch


# ---------------------------------------------------------------- k-means

def kmeans_work(n: int, dim: int, k: int, n_iter: int) -> tuple[dict, float]:
    """(flops, bytes) of one slide's k-means in f32: kmeans++ seeding (k
    distance passes of 3 n d), ``n_iter`` Lloyd steps and the final
    assignment (2 n k d each), the cluster means (2 n k d); the features read
    once and the means written once."""
    flops = 3.0 * k * n * dim + (n_iter + 2) * 2.0 * n * k * dim
    return {"float32": flops}, float(n * dim * 4 + k * dim * 4)
