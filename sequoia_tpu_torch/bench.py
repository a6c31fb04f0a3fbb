"""The H100's peak rates and the ViS training step's work: the one copy of
each that the port's rooflines and MFU divide by.

Rates are the NVIDIA H100 SXM data sheet's dense figures (no sparsity), at
the card's full 700 W; a card set to a lower power limit runs below them,
so a reading names the limit beside its share.  ``PEAK_FLOPS`` is keyed by
the route a product takes:

* ``bfloat16``: the tensor cores in bf16, 989 TFLOP/s;
* ``tf32``: the tensor cores in TF32, 495 TFLOP/s; an f32 product taken
  as three TF32 products (the port's f32 kernels) counts three times its
  FLOP at this rate;
* ``float32``: IEEE f32 on the CUDA cores, 67 TFLOP/s.

``HBM_BYTES_PER_S`` is the HBM3 rate, 3.35 TB/s.  The readers, each on the
routes it has always used:

* ``tools/profile_backbone``: a stage's bound at ``bfloat16`` or, in f32, as
  three TF32 products at ``tf32``, and bytes at the HBM rate;
* ``tools/profile_train_step``: ``mxu_floor_ms`` and ``mfu_pct_device`` at
  ``bfloat16`` over :func:`_vis_train_flops`, and its byte floors at the HBM
  rate;
* ``chip_smoke.py``'s ``bound_ms``: ``float32``, ``tf32`` (three products an
  f32 product, as above) and ``bfloat16``, and the HBM rate.

The benchmark harness keeps its own copy (``benchmark/arith.py``), which the
tests hold equal to this one where their keys meet.  The module keeps the
name of the bench it once was because ``benchmark/tests`` imports
:func:`_vis_train_flops` from it.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def _vis_train_flops(cfg, batch: int) -> float:
    """Analytic matmul FLOPs for one ViS train step (fwd + 2x for bwd).
    Elementwise/LN/mean terms are negligible next to the GEMMs."""
    T, D, H = cfg.num_clusters, cfg.input_dim, cfg.nheads
    per_block = (2 * T * D * H * cfg.dim_f            # fused f projection
                 + 2 * T * D * H * cfg.dim_s          # fused s projection
                 + 2 * T * H * (cfg.dim_f + cfg.dim_s) * cfg.dim_c  # combine
                 + 2 * T * (H * cfg.dim_c) * D        # output projection
                 + 4 * T * D * D)                     # FeedForward (D->D->D)
    fwd = cfg.depth * per_block + 2 * D * cfg.num_outputs  # + gene head
    return 3.0 * fwd * batch
