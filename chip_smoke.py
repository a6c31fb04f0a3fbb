#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sequoia_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only stem16,vis_blocks_fused   # phases 1-3 for these
    python3 chip_smoke.py --only stem16,bottleneck_chain_cp   # the f32 K2, K3 rows too
    python3 chip_smoke.py --only lloyd_stats   # phases 1-2, K5 and its k-means lines
    python3 chip_smoke.py --only uni_path      # phases 1-2 and 7
    python3 chip_smoke.py --only train_path    # phases 1-2 and 8
    python3 chip_smoke.py --only aggregators_path   # phases 1-2 and 9
    python3 chip_smoke.py --only stages_path   # phases 1-2 and 10
    python3 chip_smoke.py --only parallel_path # phases 1-2 and 11
    python3 chip_smoke.py --only raw_planes_path   # phases 1-2 and 12
    python3 chip_smoke.py --only tools_path    # phases 1-2 and 13

Phases, each printing one JSON line:

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: the CUDA kernels built from ``sequoia_tpu_torch/csrc`` (nvcc,
   ``sm_90a``), with the seconds it took;
3. kernels: each kernel (K1 vis_blocks_fused, K2 stem16, K3
   bottleneck_chain_cp, K4 bottleneck_chain, K5 lloyd_stats) against its
   plain PyTorch version on the card at the main path's shapes, in f32 and
   bf16 (K5 is f32 only), with the error against the stated tolerance, the
   kernel's time, the plain version's, one PyTorch library call's for the
   same function (K1: the plain ``vis`` block loop on cuBLAS; K2, K3, K4:
   cuDNN ``F.conv2d`` + BN + ReLU of the same layers; K5: a distance GEMM,
   argmin and ``index_add_``), and the bound (the least time the card could
   take for the same work).  K5 (``lloyd_wgmma.cu``, centered 3xTF32 on the
   tensor cores) is held against both plain versions: the mirror of its
   recipe (``lloyd_stats_tc_plain``) and the JAX kernel's uncentered f32
   recipe (``lloyd_stats_plain``, also at two ragged point counts); it
   reports its launches per call, each of its kernels' traced time, and its
   share of two bounds (TF32 tensor cores, f32 CUDA cores); past one
   128-center tile (``wide_k``: k = 129, 200, 256, each against the mirror
   with its time; at k = 200 also ``kmeans_fit`` and
   ``SlidePredictor.cluster`` with K5 on the card).  Then a
   ``kmeans_near_tie`` line (Lloyd fits with K5, plain f32 and plain f64
   from one seeding on near-equal features: steps, what kept each alive,
   labels equal to the f64 fit's) and a ``lloyd_step`` line (one K5-mode
   Lloyd step: K5's device time against the rest of the step and the host
   sync).  K1 and K2 (bf16: the tensor-core kernels of
   ``vis_wgmma.cu`` and ``stem_wgmma.cu``; f32: their 3xTF32 tensor-core
   kernels in the same sources) also report their share of the bound, GB/s
   and TFLOP/s, and are checked at off-path edge shapes (K1 in bf16: 7 and
   130 tokens at P = 512, depth 1; K2 in both types: one image, three
   images, a ragged H2 != W2 map); K1 is also checked and timed with 8 heads of
   width 128 (D = 2048) and 8 heads of width 96 (D = 1536, heads that
   straddle the 64-feature tiles), depth 6, 100 tokens (``wide_heads``, both
   types); K1 reports its launches per call and, from a
   ``torch.profiler`` trace of one call, the device gaps between them.  K3
   and K4 (bf16: the tensor-core kernel of ``conv_wgmma.cu``; f32: its
   3xTF32 kernel, K3's weights read K-major and its last launch writing the
   (C, P) layout) are timed at
   layer1's shape and also checked and timed at the three stage tails
   (layers 2-4 after their stride-2 block) and at three off-path edge
   shapes, each with its share of the bound and TFLOP/s.  The
   3xTF32 rows (every f32 row of K1-K4) are
   held against the plain f32 version at ``TOL`` and report both their
   error and the plain f32 version's against an f64 run of the plain
   version (the tensor cores truncate as they accumulate), and their
   bound as three TF32 products (with the f32 FMA bound beside it); then
   ``chain_totals`` lines in f32 and bf16 (K3 and K4 per extractor batch,
   layer1 + tails, kernel against library, and the stages where the kernel
   is at or below the library, which ``cli.compute_features.K4_STAGES``
   follows), a
   ``chain_weight_fold`` line (the per-batch cost
   of folding and casting each stage's chain weights, as every forward
   does), and ResNet ``early_pallas`` + ``cp_stages=(2, 3, 4)`` on one batch
   against the plain extractor, in bf16 (0.05) and f32 (1e-4);
4. main path: a ``SlidePredictor`` with random ResNet-50 and 5-fold ViS
   weights at full width (D=2048, depth 6, 16 heads, 20,820 genes, bf16),
   ResNet ``early_pallas``, k-means ``use_pallas`` and the fused ViS, runs
   ``predict_patches`` on a 4096-patch and a 60-patch slide of random 256-px
   patches; every launch counter must rise, the outputs must be finite
   (1, 20820), and the same slides through the plain versions must agree;
   then a ``torch.profiler`` trace of one extractor batch of each predictor
   (device ms by kernel, idle share) and each stage's time, with the Lloyd
   steps of ``kmeans_fit`` and, from one seeding, of K5, plain f32 and plain
   f64 with their labels' agreement with f64.  Then the f32 leg
   (``main_path_f32``): ``pipeline.fused.make_slide_program`` with
   ``compute_dtype`` f32, ``kernels=True`` against ``kernels=False``, and a
   ``SlidePredictor`` at ``ResNetConfig(f32, early_pallas=True)`` with f32
   ViS folds, on the same 4096-patch slide: K2, K3, K5 and K1 (all on the
   tensor cores in f32) must launch, the features within 1e-4 of the plain
   f32 extractor, r >= 0.999 on shared clusters and >= 0.99 end to end,
   seconds a slide both ways, and a trace of one f32 extractor batch;
5. WSI path: two synthetic AppMag-20 slides (8192 x 8192 level 0 with a
   textured tissue ellipse over about 75% of it, a 4x-down level 1) served
   from the slide with ``predict_wsi`` one by one and ``predict_slides``
   over both: tissue screen -> ResNet-50 with ``fused_stages=(1, 2, 3, 4)``
   (K4) -> k-means (K5) -> 5-fold ViS (K1), against a plain predictor (same
   kept patches, features within 5%, Pearson r >= 0.99), then a run at
   ``max_patches=256`` that must stop decoding early, and the same trace of
   one batch of candidates;
6. serving from files: the five folds written as a CV directory
   (``model_best_{i}.pt``, ``test_results.pkl`` with 20,820 genes) and fold
   0 as an HF directory (``serve_cli_checkpoints``: seconds to write and
   load, loaded bit for bit equal to memory); a ``native_reader`` line
   (whether g++ built the port's libtiff reader, and the compiler's message
   if not); then the kernel set of ``cli.serve.build_predictor`` (K4, K5,
   K1) over the two slides of phase 5 (``serve_cli``): written as files
   (native writer, else Pillow) and served by ``cli.serve.main`` with the
   full head, a 50-gene panel and ``--kernels off`` (CSV shapes, the panel's
   columns, rows against ``predict_wsi`` on the in-memory slides, seconds
   per slide and slides/hour, kernels against plain), then by the HTTP
   server (GET /healthz and /genes, a POST of both slides, two POSTs queued
   behind a held run that must merge into one run), and once with
   ``--compute_dtype float32`` (K4, K5 and K1 in f32, the 3xTF32 kernels)
   on the first slide against ``--kernels off`` at phase 12's f32
   tolerance (``float32``: the counts of both runs, the plain one's 0);
   with no way to write a slide file, ``predict_slides`` on the in-memory
   slides and a POST of a path that cannot be opened (502);
7. the UNI path (``uni_*`` lines): random UNI ViT-L/16 weights from a seed
   (LayerScale gammas 0.1, so that the blocks move each patch's CLS token)
   at full width in bf16, extractor batch 128, and five ViS folds of input
   1024 (depth 6, 16 x 64, 20,820 genes; outside K1's packed layout, so K1
   is off this path).  ``uni_resize``: the Pillow-exact resize of one batch
   on the card, bit-equal to the port's CPU result and to Pillow where it
   imports; ``uni_batch``: one batch's bf16 features against the f32
   forward, ms per batch of 128 against its bound (FLOP / 989 TFLOP/s), the
   ``UNI_SCAN_CHUNK`` sweep and a ``torch.profiler`` trace; ``uni_lloyd``: K5
   at (4096, 1024), k = 100, against ``lloyd_stats_tc_plain``;
   ``uni_slide``: ``predict_patches`` on a 4096- and a 60-patch slide and
   ``predict_wsi`` on the two slides of phase 5, K5 against the plain
   k-means (kept counts equal to the ResNet predictor's); ``uni_serve_cli``:
   ``cli.serve.main --feat_type uni --weights random`` on the slides as
   files, with the kernels and with ``--kernels off`` after a warm-up;
8. the training plane (``train_*`` lines; none of K1-K5 is on it, as in the
   JAX package, whose trainer reaches no Pallas kernel): ``train_parity``,
   three AdamW steps of a depth-2, D = 256, G = 1,000 ViS on the card
   against the same steps on the CPU (per leaf, tolerance 5e-4);
   ``train_step``, ms per full-width step (ViS D = 2048, depth 6, 16 x 64,
   100 tokens, G = 20,820, batch 16) in f32, with ``compute_dtype``
   bfloat16, with bf16 AdamW moments too, and the ViT in f32 (dim and MLP
   2048), each against its bound with its peak memory, the f32 and bf16 ViS
   with a ``torch.profiler`` trace of one step (device ms by GEMMs,
   optimizer and elementwise, idle share); ``train_cv``, ``cli.main`` 5-fold
   CV for 2 epochs on 80 synthetic slides of 40 patients (features from a
   seed, read from memory where h5py does not import: the substitution
   lives here, not in the package), its outputs checked;
   ``train_resume``, ``--resume --moment_dtype bfloat16`` run twice (the
   second trains nothing, its moments bf16 and bit-equal to the saved);
   ``train_gtex``, ``cli.pretrain_gtex --quick 1`` then a fine-tune with the
   head swapped to 1,000 genes; ``train_launches`` (all 0);
9. HE2RNA trained and served, the ViT served, spatial maps and
   independent-cohort prediction: ``he2rna_parity``, three Adam steps of a
   small HE2RNA (dropout 0, one k) on the card against the CPU (per leaf,
   5e-4); ``he2rna_step``, ms per full-width f32 train step (D = 2048, 256 ->
   256 -> 20,820, 100 tokens, batch 16, Dropout(0.5), k drawn per step)
   against its bound with its peak memory, a trace by op class (GEMMs, top-k,
   scatter, Adam, elementwise) and the eval k sweep's ms; ``he2rna_cv``,
   ``cli.he2rna`` 5-fold CV for 2 epochs with ``--hf_export`` on phase 8's
   cohort, then ``cli.pretrain_gtex --model he2rna --quick 1`` and a
   1,000-gene fine-tune; ``serve_models``, five ViT folds (dim and MLP 2048,
   depth 2) and five HE2RNA folds written as CV directories and served from
   phase 5's slides as files by ``cli.serve.main --model_type vit|he2rna``
   (K4, K5; ``--kernels off``; a 50-gene panel) and one HTTP POST each;
   ``spatial``, phase 5's slide 0 in a TCGA layout through
   ``cli.visualize`` (stride 1, the 50-gene panel, ViS, HE2RNA and ViT
   folds; K4 tile features), then every gene's window stage on the device
   timed and held against the host's float64 means; ``independent``,
   ``cli.predict_independent`` with the five ViS folds over phase 8's cohort;
   ``aggregators_launches`` (K4 and K5 must rise);
10. the offline stages and evaluation, through their CLIs (``stages_*``
   lines, each saying whether its HDF5 stores were real files or, where
   h5py does not import, :class:`MemoryH5`, a dict-backed stand-in put in
   ``sys.modules["h5py"]`` for the length of the phase and never inside the
   package): ``stages_patch_gen``, phase 5's two slides as files tiled by
   ``cli.patch_gen`` in the tiles and the packed layout (patches and seconds
   per slide; the layouts hold equal patches, each slide as many as phase
   5's ``predict_wsi`` kept); ``stages_features``, a third slide of 4,200
   seeded patches in the packed layout so that the cap of 4,000 binds, then
   ``cli.compute_features --weights random`` over the three in f32 and bf16,
   with K4 and with ``--kernels off`` (seconds per slide, slides/hour and ms
   per extractor batch of 256 from its StageTimer; K4's features within
   1e-4 of the plain ones' max in f32 and 5% in bf16); ``stages_kmeans``,
   ``cli.kmean_features`` with the hybrid backend with K5 and with
   ``--kernels off``, and the device backend with K5, each on its own copy
   (K5's final assignment against the float64 argmin to the same centers,
   its means against the float64 means of its labels, and its centers a
   fixed point: the float64 means of its final labels within the Lloyd
   tolerance; its inertia within 1e-3 of, and its labels and steps against,
   a float64 Lloyd fit from the same hybrid seeding; a second run writes
   nothing);
   ``stages_evaluate``, ``cli.evaluate_model`` over phase 8's five-fold
   ``test_results.pkl`` (under ``--only stages_path``, a 1-epoch
   ``cli.main`` CV on phase 8's cohort): 20,820 rows and the reference's
   columns; ``stages_launches`` (K4 and K5 must rise).  ``cli.get_emd`` and
   ``cli.gbm_analysis`` are host code that needs ``cv2`` and matplotlib; the
   phase does not run them (the CPU tests hold them against the JAX
   package);
11. multi-GPU and multi-host paths on the one card (``parallel_*`` lines):
   ``parallel_train``, an NCCL world of one (FileStore) with the full-width
   ViS f32 step (batch 16, G = 20,820) through ``loop.train(mesh=)`` for
   PAR_STEPS steps against the unsharded loop within 1e-6 relative, the NCCL
   init seconds, ms per step sharded and unsharded (CUDA events) and the
   all-reduces and their bytes per step; ``parallel_gloo``, two gloo ranks
   sharing the card (NCCL refuses two ranks on one GPU) with the meshes
   (data, model) = (1, 2) and (2, 1) of one world, each step's metrics
   within loss and mae rtol 1e-5 / corr rtol 1e-4 of one process's, every
   first AdamW moment after the steps within 1e-4 of its (per leaf,
   relative to the leaf's largest value) and every parameter leaf's update
   within 1e-3 of its (in norm), each rank's
   head and AdamW-moment bytes 1/n_model of the whole, and a
   ``torch.distributed.checkpoint`` round trip of the (1, 2) state (bit
   equal; then read into the (2, 1) layout, bit equal to the gathered
   state) with its seconds; ``parallel_dp``, a (2, 1) in-process mesh of
   the card against one device at the per-device batch: K4 extraction
   through ``load_extractor(data_parallel=True)``, K2 + K3 on one batch,
   phase 5's slide 1 through a data-parallel serving predictor (K4, K5,
   K1), and the window stage over (2, 1) and (1, 2); ``parallel_fleet``,
   ``cli.serve --multihost`` (its ``.part0`` equal to the CSV without the
   flag) and ``cli.compute_features --multihost --data_parallel`` (every
   row) in a gloo world of one through ``--coordinator file://...``;
   ``parallel_launches`` (every kernel must rise).  One card: no
   multi-card number exists;
12. raw-plane serving (``raw_*`` lines; run after phase 6, on phase 5's
   weights): phase 5's two slides as
   :class:`PlanarSlide` stand-ins for JPEG-tiled slide files (per-tile
   YCbCr planes encoded once on the card; their RGB decode rebuilt on the
   CPU by ``ops/ycbcr.planar_to_rgb``, never libjpeg) in three layouts:
   256-px tiles at 4:2:0 and 4:2:2 (``'ycbcr'``) and 240-px tiles at 4:2:0
   (``'mosaic'``, edge tiles included), each through phase 5's kernel
   predictor (K4, K5, K1) with ``predict_wsi`` and ``predict_slides``
   against the same predictor in ``'rgb'`` on the same reader after a
   warm-up of each (``raw_planes``: mode, candidates and kept, bytes
   uploaded a slide and their ratio, s/slide, launches, the kept set equal,
   max |Δ| and r of the prediction, within rtol 2e-4 / atol 1e-4 where the
   batches are 'rgb''s; the mosaic batches in spatial order, where a bf16
   row's rounding follows its place in the batch, so it is held at r
   and, through an f32 predictor, at that tolerance, with a probe of the
   backbone's place dependence in bf16 and in f32, where K4's chains must
   show 0); a
   ``raw_recon`` line (one batch of 128 planes at 4:2:0 rebuilt on the card,
   bit-equal to the CPU, ms against a bytes floor), a ``raw_retry`` line (a
   slide whose raw read fails on one tile is served in ``'rgb'`` and equals
   it), a ``raw_assemble`` line (one mosaic chunk's tile rebuild and one
   batch's gather, bit-equal to the CPU, with their ms) and
   ``raw_planes_launches`` with ``phase_seconds``;
13. the tool layer (``tools_*`` lines; ``sequoia_tpu_torch/tools``), each
   tool's JSON on its own line: ``tools_profile_backbone``, the per-stage
   profile of the ResNet-50 extractor at batch 128 in bf16 and f32 under four
   settings (plain; ``early_pallas``, K2 + K3; ``early_pallas`` with
   ``cp_stages=(2, 3, 4)``, K3; ``fused_stages=(1, 2, 3, 4)``, K4): stage ms
   (CUDA events inside one forward) against each stage's bound, the whole
   forward and patches/s, the chain-weight fold alone, launches per forward,
   device ms by class and the idle share from a trace; each setting's
   features held against the plain setting's at ``STAGE_FEAT_TOL`` and its
   stage rows within ``STAGE_SUM_TOL`` of the forward;
   ``tools_profile_train_step``, the ViS and HE2RNA train steps' pieces at
   the production shape against their floors; ``tools_validate_real_weights``,
   ``validate_real_weights`` over a hub fabricated from seeds in a temporary
   directory (a full-width ViS fold in the HF layout through K1, the ViT and
   HE2RNA fixtures, torchvision's ``resnet50.pth`` through K2 + K3 and K4,
   UNI's ``pytorch_model.bin`` at ViT-L width and depth 2; the ResNet's BN
   statistics calibrated on a seeded batch, as trained weights are), every
   row within its bound of the float64 oracle; ``tools_uncalibrated_resnet50``,
   the ResNet routes on the JAX tests' uncalibrated state dict (features in
   the thousands), each within the kernels' f32 tolerance of the largest
   feature; ``tools_host``, ``make_example_data
   --wsis`` (its TIFFs read back equal to their levels) and ``parity_check``
   on a pair of pickles that passes and one that fails;
   ``tools_launches`` (K1-K4 must rise) with ``phase_seconds``.

The last lines are the kernels table (``launches`` sums the counts of the
kernel runs of phases 4-7 and 9-13, each read from 0), the script's run time, the
``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before the last line.  Without CUDA, or without the package beside it, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time

# the main path's shapes (bench.py's slide: 4096 patches of 256 px, extractor
# batch 128, k = 100 padded to 128 centers, ViS D = 2048 over 100 tokens)
PATCHES, SMALL_SLIDE, PATCH, FEAT_BATCH = 4096, 60, 256, 128
K, KPAD, D, GENES, FOLDS = 100, 128, 2048, 20820, 5
# the ResNet chain shapes at 256 px: (stage, first stride-1 block, map side)
CHAIN_LAYER1, CHAIN_TAILS = (1, 0, 64), ((2, 1, 32), (3, 1, 16), (4, 1, 8))
# off-path chain shapes for the edges of the bf16 tensor-core kernel: (batch,
# stage, first block, H, W): a projection block first over 8 x 16 maps, one
# 8 x 8 image (fewer rows than a tile), and 9 x 15 maps (tiles that straddle
# images, a ragged last tile)
CHAIN_EDGES = ((3, 1, 0, 8, 16), (1, 4, 1, 8, 8), (2, 2, 0, 9, 15))
# the WSI path: level-0 side, the early-stop run's cap
WSI_SIDE, WSI_CAP = 8192, 256
# the serve CLI's gene panel
PANEL = 50
# off-path bf16 edge shapes: K1 (tokens, P, heads) at depth 1; K2 (batch, H2,
# W2): one image, three, and a map whose 4032 pixels end in a ragged tile
VIS_EDGES = ((7, 512, 8), (130, 512, 8))
# K1 with heads that do not fit one 64-feature tile: (heads, head width) at
# depth 6, 100 tokens, D = 2 * heads * width (2048: whole tiles a head;
# 1536: heads straddle the tiles)
VIS_WIDE_HEADS = ((8, 128), (8, 96))
# K5 past one 128-center tile: k at the main path's (4096, 2048)
LLOYD_WIDE_K = (129, 200, 256)
STEM_EDGES = ((1, 128, 128), (3, 128, 128), (2, 56, 72))
# the UNI path: feature width, the UNI_SCAN_CHUNK sweep, the LayerScale
# gammas of the random weights, and bf16 features against f32 on one batch:
# max |bf16 - f32| / max |f32| (bf16 rounds the residual stream of 24 blocks)
UNI_DIM, UNI_CHUNKS, UNI_LAYER_SCALE, UNI_BF16_TOL = 1024, (16, 32, 64, 128), 0.1, 5e-2

# the training plane at full width: the reference's batch 16 and lr 1e-3 over
# (100, 2048) cluster features, steps timed a variant; train_parity at depth 2,
# D = 256, G = 1,000 (the CPU side stays quick), held to
# tests/test_train_step_parity.py's 5e-4
TRAIN_BATCH, TRAIN_LR, TRAIN_STEPS = 16, 1e-3, 20
PARITY_DEPTH, PARITY_DIM, PARITY_GENES, PARITY_TOL = 2, 256, 1000, 5e-4
# the synthetic cohort (slides, patients) and the fine-tuning cohort's genes
CV_SLIDES, CV_PATIENTS, FT_GENES = 80, 40, 1000
# bytes a parameter that the AdamW step must move: p, m, v read and written, g read
ADAMW_BYTES = {"float32": 28, "bfloat16": 20}

# card peaks (H100 SXM data sheet, dense): the bound of a kernel is the
# larger of bytes / HBM rate and operations / peak rate for their type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tfloat32": 495e12, "bfloat16": 989e12}

# kernel vs plain version on the same inputs: max |kernel - plain| / max |plain|.
# f32: the two sum in different orders (f32 rounding only).  bf16: both round
# to bf16 at the same points, but a value that lands on a rounding boundary
# can round one ulp (2^-8) apart and carry into the next GEMM.
TOL = {"stem16": {"float32": 1e-5, "bfloat16": 1e-2},
       "bottleneck_chain_cp": {"float32": 1e-4, "bfloat16": 3e-2},
       "bottleneck_chain": {"float32": 1e-4, "bfloat16": 3e-2},
       "vis_blocks_fused": {"float32": 1e-4, "bfloat16": 3e-2},
       "lloyd_stats": {"float32": 1e-5}}
# K5 against the mirror of its own recipe: the same labels, so equal counts,
# and sums of the same rows in another order (f32 rounding only)
LLOYD_TC_SUMS_TOL = 1e-6
# the near-tie fixture: m + sigma * noise around one m = 0.5 |N(0, 1)| of
# width D, as ResNet features of near-equal patches (|x|^2 ~ 500 against a
# squared spread of D sigma^2 ~ 0.05)
NEAR_TIE_SIGMA = 0.005

# the kernels line reports each kernel's bf16 row (the main path's type):
# K1-K4 the bf16 tensor-core kernels (f32 runs the 3xTF32 kernels of the
# same sources)
SOURCES = {
    "vis_blocks_fused": ("sequoia_tpu_torch/csrc/vis_wgmma.cu",
                         "sequoia_tpu/ops/pallas_vis.py:255"),
    "stem16": ("sequoia_tpu_torch/csrc/stem_wgmma.cu",
               "sequoia_tpu/ops/pallas_resnet.py:285"),
    "bottleneck_chain_cp": ("sequoia_tpu_torch/csrc/conv_wgmma.cu",
                            "sequoia_tpu/ops/pallas_resnet.py:377"),
    "bottleneck_chain": ("sequoia_tpu_torch/csrc/conv_wgmma.cu",
                         "sequoia_tpu/ops/pallas_resnet.py:151"),
    "lloyd_stats": ("sequoia_tpu_torch/csrc/lloyd_wgmma.cu",
                    "sequoia_tpu/ops/pallas_kmeans.py:81"),
}


START = time.perf_counter()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def rates(res: dict, nbytes_: float, flops: float) -> dict:
    """Share of the bound, GB/s and TFLOP/s of a kernel row's time."""
    return {"bound_share": res["bound_ms"] / res["ms"], "gbps": nbytes_ / res["ms"] / 1e6,
            "tflops": flops / res["ms"] / 1e9}


def launch_gaps(torch, fn, match: str) -> dict:
    """One call of fn traced with torch.profiler: its device kernels whose
    name holds ``match``, their count, the span from the first start to the
    last end, and the gaps between one kernel's end and the next one's start
    (negative where programmatic dependent launch lets them overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                if e.device_type == DeviceType.CUDA and match in e.name)
    if not ev:
        raise AssertionError(f"profile: no device kernel named *{match}* in the trace")
    gaps = [b[0] - a[1] for a, b in zip(ev, ev[1:])] or [0.0]
    # per kernel (its name without namespace and arguments): launches, mean
    # time from start to end, mean gap from the previous kernel's end
    by_name: dict = {}
    for i, (s, e, name) in enumerate(ev):
        fn = re.search(r"(\w+(?:<[^()]*>)?)\(", name.replace("(anonymous namespace)::", ""))
        short = fn.group(1) if fn else name[:60]
        n, dur, gap = by_name.get(short, (0, 0.0, 0.0))
        by_name[short] = (n + 1, dur + e - s, gap + (s - ev[i - 1][1] if i else 0.0))
    return {"kernels_traced": len(ev), "span_ms": (ev[-1][1] - ev[0][0]) / 1e3,
            "kernel_ms_sum": sum(e - s for s, e, _ in ev) / 1e3,
            "gap_us_mean": sum(gaps) / len(gaps), "gap_us_min": min(gaps),
            "gap_us_max": max(gaps), "gap_us_sum": sum(gaps),
            "by_kernel": {k: {"launches": n, "us_mean": dur / n, "gap_before_us_mean": gap / n}
                          for k, (n, dur, gap) in by_name.items()}}


def time_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_batch(torch, fn, iters: int = 3, kind=None) -> dict:
    """Device time of fn (one extractor batch) by kernel name from a
    torch.profiler trace, and the device's idle share of the traced window
    (host clock, ending in a synchronize; the profiler's own host cost is in
    the window, so the share is an upper estimate); with ``kind`` (kernel
    name -> class) also the device ms per call of each class."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # warm-up: the tracer's own start-up stays out
        fn()
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    spans: dict = {}  # record_function ranges on the device timeline: not kernels
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            into = spans if getattr(e, "is_user_annotation", False) else by_name
            ms, n = into.get(e.name, (0.0, 0))
            into[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    res = {"wall_ms_per_batch": wall_ms / iters, "device_ms_per_batch": busy_ms / iters,
           "idle_share": 1 - busy_ms / wall_ms,
           "device_events_per_batch": sum(n for _, n in by_name.values()) / iters,
           "top": [{"kernel": k[:90], "ms_per_batch": ms / iters, "calls_per_batch": n / iters}
                   for k, (ms, n) in top]}
    if spans:
        res["device_spans_ms_per_batch"] = {k[:60]: ms / iters for k, (ms, _) in spans.items()}
    if kind is not None:
        classes: dict = {}
        for name, (ms, n) in by_name.items():
            c = classes.setdefault(kind(name), {"ms_per_call": 0.0, "kernels_per_call": 0.0})
            c["ms_per_call"] += ms / iters
            c["kernels_per_call"] += n / iters
        res["by_kind"] = classes
    return res


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def compare(torch, name, dtype, got, want) -> dict:
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name} {dtype}: kernel output not finite")
    err = float((got - want).abs().max())
    scale = max(float(want.abs().max()), 1e-30)
    rel = err / scale
    tol = TOL[name][dtype]
    if rel > tol:
        raise AssertionError(f"{name} {dtype}: max|kernel-plain|/max|plain| = {rel:.3g} "
                             f"> {tol:g}")
    return {"max_abs_err": err, "max_rel_err": rel, "tol": tol}


def f64_errors(torch, got, plain32, plain64) -> dict:
    """A 3xTF32 kernel's error against an f64 run of its plain version,
    beside the f32 plain version's own (max |diff| / max |f64|): the tensor
    cores truncate as they accumulate, and this shows what that costs."""
    scale = max(float(plain64.abs().max()), 1e-300)
    return {"max_rel_err_vs_f64": float((got.double() - plain64).abs().max()) / scale,
            "plain_max_rel_err_vs_f64": float((plain32.double() - plain64).abs().max()) / scale}


def kernel_bounds(moved: float, flops: float, dtype: str, ms: float, tf32: bool) -> dict:
    """bound_ms / bound_by / bound_share of a kernel row.  A 3xTF32 kernel
    (``tf32``) is bound by its three TF32 products on the tensor cores (as
    K5's row); its f32 FMA bound on the CUDA cores is given beside it."""
    if not tf32:
        b, by = bound_ms(moved, flops, dtype)
        return {"bound_ms": b, "bound_by": by, "bound_share": b / ms}
    b, by = bound_ms(moved, 3 * flops, "tfloat32")
    bc, bcby = bound_ms(moved, flops, "float32")
    return {"bound_ms": b, "bound_by": by, "bound_share": b / ms,
            "bound_bytes_ms": moved / HBM_BYTES_PER_S * 1e3,
            "bound_bytes_share": moved / HBM_BYTES_PER_S * 1e3 / ms,
            "bound_cuda_cores_ms": bc, "bound_cuda_cores_by": bcby,
            "bound_cuda_cores_share": bc / ms}


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------

def check_stem16(torch, dev, dtype: str) -> dict:
    import torch.nn.functional as F
    from sequoia_tpu_torch.models import resnet
    from sequoia_tpu_torch.ops import cuda_resnet

    g = torch.Generator(device=dev).manual_seed(1)
    dt = getattr(torch, dtype)
    params = resnet.random_params(g)
    img = torch.randn((FEAT_BATCH, PATCH, PATCH, 3), generator=g, device=dev).to(dt)
    h2 = w2 = PATCH // 2
    x16 = F.pad(resnet._space_to_depth(img), (0, 0, 2, 1, 0, 4)).reshape(
        FEAT_BATCH, 16, (h2 + 3) * w2).contiguous()
    a, b = cuda_resnet.fold_stem16_weights(params["conv1_s2d"], params["bn1"], dt)
    run = lambda: cuda_resnet.stem16(x16, a, b, H2=h2, W2=w2)  # noqa: E731
    plain = lambda: cuda_resnet.stem16_plain(x16, a, b, H2=h2, W2=w2)  # noqa: E731
    out = run()
    want = plain()
    res = compare(torch, "stem16", dtype, out, want)
    # yardstick: cuDNN's 7x7/s2 conv + BN + ReLU on the same image batch
    img_nchw = img.permute(0, 3, 1, 2).contiguous()
    w = params["conv1"].to(dt)
    s = params["bn1"]["scale"].to(dt)[:, None, None]
    bb = params["bn1"]["bias"].to(dt)[:, None, None]
    lib = lambda: torch.relu(F.conv2d(img_nchw, w, stride=2, padding=3) * s + bb)  # noqa: E731
    p_out = h2 * w2
    if dtype == "float32":  # the 3xTF32 kernel and the plain f32 against f64
        res.update(f64_errors(torch, out, want, cuda_resnet.stem16_plain(
            x16.double(), a.double(), b.double(), H2=h2, W2=w2)))
    del want
    res.update(ms=time_ms(torch, run, 10), plain_ms=time_ms(torch, plain, 2),
               library_ms=time_ms(torch, lib, 10))
    flops = 2 * FEAT_BATCH * 64 * 256 * p_out
    moved = nbytes(x16, a, b, out)
    res.update(kernel_bounds(moved, flops, dtype, res["ms"], tf32=dtype == "float32"))
    res.update(rates(res, moved, flops))
    res["edges"] = []
    for batch, eh, ew in STEM_EDGES:
        e16 = torch.randn((batch, 16, (eh + 3) * ew), generator=g, device=dev).to(dt)
        e16[:, 12:] = 0  # the 4 padding channels, as the extractor's input
        got = cuda_resnet.stem16(e16, a, b, H2=eh, W2=ew)
        res["edges"].append({"batch": batch, "map": [eh, ew], **compare(
            torch, "stem16", dtype, got, cuda_resnet.stem16_plain(e16, a, b, H2=eh, W2=ew))})
    return res


def check_chain(torch, dev, dtype: str, kname: str) -> dict:
    """K3 (``bottleneck_chain_cp``, (C, P)) or K4 (``bottleneck_chain``,
    (P, C)) against its plain version at layer1, the three stage tails and
    the off-path edge shapes; the row's numbers are layer1's, the tails' go
    under ``tails``, the edges' under ``edges``.  In f32 (3xTF32) every
    shape also gives its error against an f64 run of the plain version."""
    from sequoia_tpu_torch.models import resnet
    from sequoia_tpu_torch.ops import cuda_resnet as cr

    pc = kname == "bottleneck_chain"
    fold, kernel, plain_fn = ((cr.stage_chain_weights, cr.bottleneck_chain,
                               cr.bottleneck_chain_plain) if pc else
                              (cr.stage_chain_weights_cp, cr.bottleneck_chain_cp,
                               cr.bottleneck_chain_cp_plain))
    g = torch.Generator(device=dev).manual_seed(2)
    dt = getattr(torch, dtype)
    params = resnet.random_params(g)
    shapes = [(FEAT_BATCH, stage, start, H, H) for stage, start, H in (CHAIN_LAYER1,
                                                                       *CHAIN_TAILS)]
    shapes += CHAIN_EDGES
    res, tails, edges = None, [], []
    for batch, stage, start, H, W in shapes:
        blocks = params[f"layer{stage}"]
        flat, meta = fold(blocks, start, dt)
        x = torch.relu(torch.randn((batch, meta[0][0], H * W), generator=g,
                                   device=dev)).to(dt)
        xk = x.transpose(1, 2).contiguous() if pc else x
        run = lambda: kernel(xk, flat, meta=meta, H=H, W=W)  # noqa: E731
        plain = lambda: plain_fn(xk, flat, meta=meta, H=H, W=W)  # noqa: E731
        out = run()
        want = plain()
        r = compare(torch, kname, dtype, out, want)
        if dtype == "float32":  # the 3xTF32 kernel and the plain f32 against f64
            r.update(f64_errors(torch, out, want, plain_fn(
                xk.double(), tuple(t.double() for t in flat), meta=meta, H=H, W=W)))
        del want
        # yardstick: cuDNN's conv + BN + ReLU chain of the same blocks (the
        # plain extractor's own loop), in the layout the kernel's path uses
        x4 = x.reshape(batch, -1, H, W).contiguous(
            memory_format=torch.channels_last if pc else torch.contiguous_format)

        def lib(x4=x4, blocks=blocks[start:]):
            for blk in blocks:
                x4 = resnet._bottleneck(x4, blk, 1)
            return x4

        flops = 2 * batch * H * W * sum(ci * w + 9 * w * w + w * co + (ci * co if ds else 0)
                                        for ci, w, co, ds in meta)
        r.update(ms=time_ms(torch, run, 10), library_ms=time_ms(torch, lib, 10))
        r.update(kernel_bounds(nbytes(x, out, *flat), flops, dtype, r["ms"],
                               tf32=dtype == "float32"))
        r["tflops"] = flops / r["ms"] / 1e9
        if (batch, stage, start, H) == (FEAT_BATCH, *CHAIN_LAYER1):
            r["plain_ms"] = time_ms(torch, plain, 2)
            res = r
        elif batch == FEAT_BATCH:
            tails.append({"stage": stage, "map": H, **r})
        else:
            edges.append({"batch": batch, "stage": stage, "first_block": start,
                          "map": [H, W], **r})
    res["tails"], res["edges"] = tails, edges
    return res


def chain_totals(results: dict) -> dict:
    """K3's and K4's per-extractor-batch time (layer1 + the three tails),
    kernel against library, from their rows of one type, and per ResNet
    stage (layer1's chain from block 0, each tail from block 1) whether the
    kernel is at or below the library (``cli.compute_features.K4_STAGES``
    follows the f32 and bf16 K4 lines)."""
    out = {}
    for kname in ("bottleneck_chain", "bottleneck_chain_cp"):
        if kname not in results:
            continue
        rows = [results[kname], *results[kname]["tails"]]
        out[kname] = {key: sum(r[key] for r in rows)
                      for key in ("ms", "library_ms", "bound_ms")}
        out[kname]["kernel_over_library"] = out[kname]["ms"] / out[kname]["library_ms"]
        out[kname]["stages_at_or_below_library"] = [
            s for s, r in zip((1, 2, 3, 4), rows) if r["ms"] <= r["library_ms"]]
    return out


# launches a call: K3 over layer1 (3 blocks, 3 a block) from patches; K4 over
# a batch's four chains (layer1 from block 0, the tails from block 1: 3 + 3 +
# 5 + 2 blocks) from the WSI
K3_LAYER1_LAUNCHES, K4_BATCH_LAUNCHES = 3 * 3, 3 * (3 + 3 + 5 + 2)


def slide_costs(rows: dict, totals: dict, launches: dict) -> dict:
    """Per kernel of one slide's run: its calls (from the run's launch
    counts) times its row's ms minus its bound, the device time the slide
    loses to the kernel's distance from its bound (ROADMAP's order of kernel
    work).  ``rows``: the kernel rows of the run's type, K5's included;
    ``totals``: that type's chain_totals (K4 is timed per batch's chains)."""
    out = {}
    for k, n in launches.items():
        if not n:
            continue
        r = rows[k]
        ms, bound = r["ms"], r["bound_ms"]
        if k == "bottleneck_chain":
            calls = n / K4_BATCH_LAUNCHES
            ms, bound = totals[k]["ms"], totals[k]["bound_ms"]
        elif k == "bottleneck_chain_cp":
            calls = n / K3_LAYER1_LAUNCHES
        elif k == "lloyd_stats":  # one fit a slide: its plan, then the Lloyd steps
            calls = (n - r["launches_per_fit"]) / r["launches_per_call"]
        else:
            calls = n / r.get("launches_per_call", 1)
        out[k] = {"calls": calls, "ms": ms, "bound_ms": bound,
                  "lost_ms": calls * (ms - bound)}
    return out


def time_weight_folds(torch, dev) -> dict:
    """The per-batch cost of folding and casting the chain weights, which
    models/resnet.py does on every forward (stage_chain_weights* per chained
    stage: layer1 from block 0, the tails from block 1), bf16, device ms per
    stage and in all."""
    from sequoia_tpu_torch.models import resnet
    from sequoia_tpu_torch.ops import cuda_resnet as cr

    params = resnet.random_params(torch.Generator(device=dev).manual_seed(8))
    out = {}
    for kname, fold in (("bottleneck_chain", cr.stage_chain_weights),
                        ("bottleneck_chain_cp", cr.stage_chain_weights_cp)):
        ms = {f"layer{stage}": time_ms(torch, lambda fold=fold, stage=stage, start=start: fold(
            params[f"layer{stage}"], start, torch.bfloat16), 5)
              for stage, start, _ in (CHAIN_LAYER1, *CHAIN_TAILS)}
        out[kname] = {**ms, "all": sum(ms.values())}
    return out


def check_cp_stages(torch, dev, dtype: str) -> dict:
    """ResNet-50 ``early_pallas`` + ``cp_stages=(2, 3, 4)`` (K2 + K3 over
    every stride-1 run) on one batch against the plain extractor, at the
    stages' feature tolerance for the type (``STAGE_FEAT_TOL``)."""
    from sequoia_tpu_torch.models import resnet

    g = torch.Generator(device=dev).manual_seed(5)
    params = resnet.random_params(g)
    u8 = torch.randint(0, 256, (FEAT_BATCH, PATCH, PATCH, 3), generator=g, device=dev,
                       dtype=torch.uint8)
    cfg = dict(compute_dtype=getattr(torch, dtype))
    got = resnet.extract_from_uint8(
        resnet.ResNetConfig(early_pallas=True, cp_stages=(2, 3, 4), **cfg), params, u8)
    want = resnet.extract_from_uint8(resnet.ResNetConfig(**cfg), params, u8)
    rel = float((got - want).abs().max() / want.abs().max())
    tol = STAGE_FEAT_TOL[dtype]
    if not bool(torch.isfinite(got).all()) or rel > tol:
        raise AssertionError(f"cp_stages extractor {dtype}: max rel diff {rel:.3g} > {tol:g}")
    return {"dtype": dtype, "shape": list(got.shape), "max_rel_diff_vs_plain": rel,
            "tol": tol}


def check_lloyd(torch, dev) -> dict:
    """K5 on clustered points (as a slide's Lloyd steps see them: no point
    sits on a near-tie that f32 summation order could flip) against the
    mirror of its recipe at the main path's k = 100 centers, and against the
    JAX kernel's recipe with 128 centers padded by 1e8 sentinels at the full
    and two ragged point counts.  The row's times are the main path's shape."""
    import torch.nn.functional as F
    from sequoia_tpu_torch import _build
    from sequoia_tpu_torch.ops import cuda_kmeans as ck

    g = torch.Generator(device=dev).manual_seed(3)
    true = torch.randn((K, D), generator=g, device=dev)
    lab = torch.randint(0, K, (PATCHES,), generator=g, device=dev)
    x = true[lab] + 0.1 * torch.randn((PATCHES, D), generator=g, device=dev)
    centers = true + 0.01 * torch.randn((K, D), generator=g, device=dev)
    cpad = F.pad(centers, (0, 0, 0, KPAD - K), value=1e8)
    mask = torch.ones((PATCHES,), dtype=torch.bool, device=dev)
    mask[-96:] = False  # ragged valid count: masked rows contribute nothing
    tol = TOL["lloyd_stats"]["float32"]
    plan = ck.LloydPlan(x, mask)
    run = lambda: plan.stats(centers)  # noqa: E731
    mirror = lambda: ck.lloyd_stats_tc_plain(x, mask, centers)  # noqa: E731

    # the kernel against the mirror of its recipe: the same labels
    (s1, c1, i1, b1, l1), (s2, c2, i2, b2, l2) = run(), mirror()
    if not torch.equal(c1, c2) or not torch.equal(l1.long(), l2):
        raise AssertionError("lloyd_stats: labels or counts differ from lloyd_stats_tc_plain")
    if bool(b1[-96:].ne(0).any()) or bool(l1[-96:].ne(-1).any()):
        raise AssertionError("lloyd_stats: masked rows have best != 0 or a label")
    sums_rel = float((s1 - s2).abs().max() / s2.abs().max())
    if sums_rel > LLOYD_TC_SUMS_TOL:
        raise AssertionError(f"lloyd_stats: sums {sums_rel:.3g} from lloyd_stats_tc_plain")
    # best = |xc - cc|^2 to the chosen center, summed over D in another order
    best_rel = float((b1 - b2).abs().max() / b2.abs().max())
    inertia_rel = float((i1 - i2).abs() / i2.abs())
    if best_rel > tol or inertia_rel > tol:
        raise AssertionError(f"lloyd_stats: best {best_rel:.3g} or inertia {inertia_rel:.3g} "
                             "from lloyd_stats_tc_plain")
    res = {"vs_tc_plain": {"counts_equal": True, "labels_equal": True,
                           "sums_max_rel_err": sums_rel, "sums_tol": LLOYD_TC_SUMS_TOL,
                           "best_max_rel_err": best_rel, "inertia_rel_err": inertia_rel,
                           "tol": tol}}

    # the kernel against the JAX kernel's uncentered recipe, sentinel-padded
    (s3, c3, i3, b3), (s4, c4, i4, b4) = (ck.lloyd_stats(x, mask, cpad),
                                          ck.lloyd_stats_plain(x, mask, cpad))
    if not torch.equal(c3, c4):
        raise AssertionError("lloyd_stats: counts differ from the plain version")
    res.update(compare(torch, "lloyd_stats", "float32", s3, s4))
    if float((i3 - i4).abs() / i4.abs()) > tol:
        raise AssertionError(f"lloyd_stats: inertia {float(i3)} vs {float(i4)}")
    # the plain best, uncentered, is exact only to f32 precision of |x|^2 + |c|^2
    terms = float((x * x).sum(1).max() + (centers * centers).sum(1).max())
    if float((b3 - b4).abs().max()) > tol * terms:
        raise AssertionError("lloyd_stats: best differs from the plain version")
    for n in (SMALL_SLIDE, 1007):  # ragged point counts: the kernel masks its edge
        (rs, rc, _, _), (ps, pc, _, _) = (ck.lloyd_stats(x[:n], mask[:n], cpad),
                                          ck.lloyd_stats_plain(x[:n], mask[:n], cpad))
        if not torch.equal(rc, pc) or float((rs - ps).abs().max()) > tol * float(
                ps.abs().max()):
            raise AssertionError(f"lloyd_stats: N={n} differs from the plain version")

    def lib():  # yardstick: distance GEMM + argmin + index_add_ + bincount
        d2 = (x * x).sum(1, keepdim=True) + (centers * centers).sum(1) - 2.0 * (x @ centers.T)
        lbl = torch.argmin(d2, 1)
        sums = torch.zeros_like(centers).index_add_(0, lbl[mask], x[mask])
        return sums, torch.bincount(lbl[mask], minlength=K)

    before = _build.LAUNCHES["lloyd_stats"]
    run()
    res["launches_per_call"] = _build.LAUNCHES["lloyd_stats"] - before
    before = _build.LAUNCHES["lloyd_stats"]
    ck.LloydPlan(x, mask)
    res["launches_per_fit"] = _build.LAUNCHES["lloyd_stats"] - before
    res.update(ms=time_ms(torch, run, 50), plain_ms=time_ms(torch, mirror, 20),
               plain_uncentered_ms=time_ms(torch, lambda: ck.lloyd_stats_plain(
                   x, mask, centers), 20),
               library_ms=time_ms(torch, lib, 20),
               prepare_ms=time_ms(torch, lambda: ck.LloydPlan(x, mask), 20))
    # each kernel of a call alone (traced): lloyd_centers, lloyd_assign, lloyd_sums
    res["profile"] = launch_gaps(torch, run, "lloyd_")
    res["sums_ms"] = res["profile"]["by_kernel"]["lloyd_sums"]["us_mean"] / 1e3
    res["assign_ms"] = res["profile"]["by_kernel"]["lloyd_assign"]["us_mean"] / 1e3
    # lloyd_assign alone by point count: 8 to 32 clusters of 4 CTAs (N = 4096
    # is the main path's, 1024 about a slide served from the WSI)
    res["assign_us_by_points"] = {}
    for n in (1024, 2048, PATCHES):
        sub = ck.LloydPlan(x[:n], mask[:n])
        res["assign_us_by_points"][n] = launch_gaps(torch, lambda sub=sub: sub.stats(
            centers), "lloyd_assign")["by_kernel"]["lloyd_assign"]["us_mean"]
    n_valid = int(mask.sum())
    flops = 2 * PATCHES * D * K  # the distance product; the member-row sums add n_valid * D
    moved = nbytes(x, mask, centers, s1, c1, i1, b1)
    # the f32-accurate product as three TF32 products on the tensor cores, and
    # as one f32 product on the CUDA cores
    res["bound_ms"], res["bound_by"] = bound_ms(moved, 3 * flops + n_valid * D, "tfloat32")
    res["bound_cuda_cores_ms"], res["bound_cuda_cores_by"] = bound_ms(
        moved, flops + n_valid * D, "float32")
    res.update(rates(res, moved, 3 * flops))
    res["bound_cuda_cores_share"] = res["bound_cuda_cores_ms"] / res["ms"]
    res["wide_k"] = [check_lloyd_k(torch, dev, k) for k in LLOYD_WIDE_K]
    return res


def check_lloyd_k(torch, dev, k: int, dim: int = D) -> dict:
    """K5 with k clusters on (4096, dim) points (past one 128-center tile at
    the main path's dim; the UNI width at k = 100) against the mirror of its
    recipe (equal counts and labels, sums within LLOYD_TC_SUMS_TOL of max
    |plain|, best and inertia within TOL), its time per call, the mirror's,
    and the bound."""
    from sequoia_tpu_torch.ops import cuda_kmeans as ck

    g = torch.Generator(device=dev).manual_seed(30 + k + dim)
    true = torch.randn((k, dim), generator=g, device=dev)
    x = true[torch.randint(0, k, (PATCHES,), generator=g, device=dev)] + 0.1 * torch.randn(
        (PATCHES, dim), generator=g, device=dev)
    centers = true + 0.01 * torch.randn((k, dim), generator=g, device=dev)
    mask = torch.ones((PATCHES,), dtype=torch.bool, device=dev)
    mask[-32:] = False
    plan = ck.LloydPlan(x, mask)
    (s1, c1, i1, b1, l1), (s2, c2, i2, b2, l2) = (plan.stats(centers),
                                                  ck.lloyd_stats_tc_plain(x, mask, centers))
    if not torch.equal(c1, c2) or not torch.equal(l1.long(), l2):
        raise AssertionError(f"lloyd_stats k={k}: labels or counts differ from "
                             "lloyd_stats_tc_plain")
    sums_rel = float((s1 - s2).abs().max() / s2.abs().max())
    best_rel = float((b1 - b2).abs().max() / b2.abs().max())
    inertia_rel = float((i1 - i2).abs() / i2.abs())
    tol = TOL["lloyd_stats"]["float32"]
    if sums_rel > LLOYD_TC_SUMS_TOL or best_rel > tol or inertia_rel > tol:
        raise AssertionError(f"lloyd_stats k={k}: sums {sums_rel:.3g}, best {best_rel:.3g}, "
                             f"inertia {inertia_rel:.3g} from lloyd_stats_tc_plain")
    flops = 2 * PATCHES * dim * k
    moved = nbytes(x, mask, centers, s1, c1, i1, b1)
    bnd, by = bound_ms(moved, 3 * flops + int(mask.sum()) * dim, "tfloat32")
    res = {"k": k, "points": PATCHES, "dim": dim, "counts_equal": True, "labels_equal": True,
           "sums_max_rel_err": sums_rel, "best_max_rel_err": best_rel,
           "inertia_rel_err": inertia_rel, "tol": tol,
           "ms": time_ms(torch, lambda: plan.stats(centers), 50),
           "plain_ms": time_ms(torch, lambda: ck.lloyd_stats_tc_plain(x, mask, centers), 10),
           "bound_ms": bnd, "bound_by": by}
    res["bound_share"] = bnd / res["ms"]
    if k == 200 and dim == D:  # the entry points that refused k > 128 on the card before
        from sequoia_tpu_torch.ops import kmeans as km
        from sequoia_tpu_torch.serve import SlidePredictor

        fits = {kern: km.kmeans_fit(x, mask, torch.Generator(device=dev).manual_seed(0), k,
                                    use_pallas=kern) for kern in (True, False)}
        same = float((fits[True][1] == fits[False][1])[mask].float().mean())
        cf = SlidePredictor(None, [], n_clusters=k, use_pallas_kmeans=True,
                            device=dev).cluster(x[mask])
        if same < 0.999 or cf.shape != (k, D) or not bool(torch.isfinite(cf).all()):
            raise AssertionError(f"kmeans k={k}: K5 fit labels {same:.4f} equal to the plain "
                                 f"fit's, cluster means {tuple(cf.shape)}")
        res["kmeans_fit"] = {"steps": fits[True][3], "plain_steps": fits[False][3],
                             "labels_equal_plain": same, "slide_predictor_cluster": list(cf.shape)}
    return res


def lloyd_backends(torch, km, x, mask, init, max_iter: int = 300) -> dict:
    """``ops/kmeans._lloyd`` from one seeding with K5 (``use_pallas``), the
    plain f32 backend and the plain backend on f64 operands: steps, the
    steps the shift and an empty cluster kept the loop alive, seconds, and
    the share of labels equal to the f64 fit's."""
    out, labels = {}, {}
    for name, dtype, kernel in (("plain_f64", torch.float64, False),
                                ("lloyd_stats", torch.float32, True),
                                ("plain", torch.float32, False)):
        xd, trace = x.to(dtype), []
        t0 = time.perf_counter()
        _, labels[name], inertia, steps = km._lloyd(
            xd, mask, init.to(dtype), max_iter, km._tol_abs(xd, mask, 1e-4), kernel, trace)
        torch.cuda.synchronize()
        out[name] = {"steps": steps, "alive_by_shift": sum(s for s, _ in trace),
                     "alive_by_empty": sum(e for _, e in trace), "inertia": float(inertia),
                     "seconds": time.perf_counter() - t0}
    for name in out:
        same = labels[name][mask] == labels["plain_f64"][mask]
        out[name]["labels_equal_f64"] = float(same.float().mean())
    return out


def near_tie_features(torch, dev):
    """Near-tie features at the main path's shape (4096 x 2048) from a seed,
    all valid, and k = 100 kmeans++ centers drawn from them."""
    from sequoia_tpu_torch.ops import kmeans as km

    g = torch.Generator(device=dev).manual_seed(9)
    m = 0.5 * torch.randn((D,), generator=g, device=dev).abs()
    x = m + NEAR_TIE_SIGMA * torch.randn((PATCHES, D), generator=g, device=dev)
    mask = torch.ones((PATCHES,), dtype=torch.bool, device=dev)
    return x, mask, km._plusplus_init(torch.Generator(device=dev).manual_seed(0), x, mask, K)


def kmeans_near_tie(torch, km, x, mask, init) -> dict:
    """Lloyd fits on the near-tie features from one seeding: K5's centered
    3xTF32 distances should follow the f64 fit (same steps, every label),
    where the plain f32 backend's uncentered ones need not."""
    runs = lloyd_backends(torch, km, x, mask, init)
    k5, f64 = runs["lloyd_stats"], runs["plain_f64"]
    return {"points": PATCHES, "dim": D, "k": K, "sigma": NEAR_TIE_SIGMA,
            "sq_norm_mean": float((x * x).sum(1).mean()),
            "sq_spread_mean": float(((x - x.mean(0)) ** 2).sum(1).mean()), "backends": runs,
            "k5_follows_f64": k5["steps"] == f64["steps"] and k5["labels_equal_f64"] == 1.0}


def lloyd_step_profile(torch, km, x, mask, init, iters: int = 20) -> dict:
    """One K5-mode Lloyd step (``ops/kmeans._lloyd_step`` and its host sync)
    at the main path's shape: on the host clock the time to enqueue it and
    the time waiting in the sync; from a ``torch.profiler`` trace K5's
    device time and the rest of the step's device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    stats = km._stats_fn(x, mask, True)
    tol = km._tol_abs(x, mask, 1e-4)

    def step():
        return km._lloyd_step(x, init, stats, tol, 0)[1]

    for _ in range(3):
        step().tolist()
    torch.cuda.synchronize()
    enqueue = wait = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        alive = step()
        t1 = time.perf_counter()
        alive.tolist()
        enqueue, wait = enqueue + t1 - t0, wait + time.perf_counter() - t1
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            step().tolist()
    k5 = other = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if "lloyd_" in e.name:
                k5 += e.time_range.elapsed_us()
            else:
                other += e.time_range.elapsed_us()
    wall = (enqueue + wait) * 1e3 / iters
    return {"wall_ms": wall, "host_enqueue_ms": enqueue * 1e3 / iters,
            "host_sync_wait_ms": wait * 1e3 / iters, "k5_device_ms": k5 / 1e3 / iters,
            "other_device_ms": other / 1e3 / iters,
            "device_idle_share": 1 - (k5 + other) / 1e3 / iters / wall}


def check_vis(torch, dev, dtype: str) -> dict:
    from sequoia_tpu_torch.models import vis
    from sequoia_tpu_torch.ops import cuda_vis

    cfg = vis.ViSConfig(num_outputs=GENES, input_dim=D, num_clusters=K)
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(4)
    params = vis.init(cfg, g)
    chunks, smalls, pos = cuda_vis.pack_vis_blocks(cfg, params, getattr(torch, dtype))
    x = torch.randn((K, D), generator=g, device=dev)
    kw = dict(depth=cfg.depth, nheads=cfg.nheads)
    run = lambda: cuda_vis.vis_blocks_fused(x, pos, chunks, smalls, **kw)  # noqa: E731
    plain = lambda: cuda_vis.vis_blocks_plain(x, pos, chunks, smalls, **kw)  # noqa: E731
    out = run()
    want = plain()
    res = compare(torch, "vis_blocks_fused", dtype, out, want)
    if dtype == "float32":  # the 3xTF32 kernel and the plain f32 against f64
        res.update(f64_errors(torch, out, want, cuda_vis.vis_blocks_plain(
            x.double(), pos.double(), chunks.double(), smalls.double(), **kw)))
    # yardstick: the plain ViS block loop (pos-emb add and the blocks of
    # vis.apply, cuBLAS GEMMs) on the same tokens
    # with its weight matrices already in the compute type, as K1's are
    vcfg = dataclasses.replace(cfg, compute_dtype=dtype)
    blocks = [{k: v[i].to(dt) if k.startswith("w") else v[i] for k, v in params["blocks"].items()}
              for i in range(cfg.depth)]
    pos_emb = params["pos_emb"].to(dt)

    def lib():
        y = x[None].to(dt) + pos_emb
        for bp in blocks:
            y = vis._block(vcfg, y, bp)
        return y

    res.update(ms=time_ms(torch, run, 10), plain_ms=time_ms(torch, plain, 10),
               library_ms=time_ms(torch, lib, 10))
    p, hw, item = D // 2, D // 2 // cfg.nheads, chunks.element_size()
    weights = cfg.depth * (14 * p * p + 2 * p * hw)  # the diagonal of the combine only
    # every weight meets each of the K tokens, but the summary's share of the
    # combine (p * hw per block) meets only the one token-mean row
    flops = 2 * K * weights - 2 * (K - 1) * cfg.depth * p * hw
    moved = weights * item + nbytes(smalls, x, pos, out)
    res.update(kernel_bounds(moved, flops, dtype, res["ms"], tf32=dtype == "float32"))
    res.update(rates(res, moved, flops))
    from sequoia_tpu_torch import _build

    before = _build.LAUNCHES["vis_blocks_fused"]
    run()
    res["launches_per_call"] = _build.LAUNCHES["vis_blocks_fused"] - before
    res["profile"] = launch_gaps(torch, run, "vis_")
    if dtype == "bfloat16":
        res["edges"] = []
        for n, ep, heads in VIS_EDGES:
            ecfg = vis.ViSConfig(num_outputs=16, input_dim=2 * ep, depth=1, nheads=heads,
                                 dim_f=ep // heads, dim_s=ep // heads, dim_c=ep // heads,
                                 num_clusters=n)
            ech, esm, epos = cuda_vis.pack_vis_blocks(ecfg, vis.init(ecfg, g), dt)
            ex = torch.randn((n, 2 * ep), generator=g, device=dev)
            ekw = dict(depth=1, nheads=heads)
            res["edges"].append({"tokens": n, "P": ep, "depth": 1, **compare(
                torch, "vis_blocks_fused", dtype,
                cuda_vis.vis_blocks_fused(ex, epos, ech, esm, **ekw),
                cuda_vis.vis_blocks_plain(ex, epos, ech, esm, **ekw))})
    res["wide_heads"] = [check_vis_wide_heads(torch, dev, g, dtype, heads, hw)
                         for heads, hw in VIS_WIDE_HEADS]
    return res


def check_vis_wide_heads(torch, dev, g, dtype: str, heads: int, hw: int) -> dict:
    """K1 with heads that do not fit one 64-feature tile (the per-head LN
    runs as a launch of its own, the combine takes the rows of the tile's
    heads) at the main path's depth and tokens, at the 16 x 64 TOL: bf16
    against the plain version of its decomposition
    (``vis_blocks_split_plain``), f32 against ``vis_blocks_plain``."""
    from sequoia_tpu_torch import _build
    from sequoia_tpu_torch.models import vis
    from sequoia_tpu_torch.ops import cuda_vis

    d = 2 * heads * hw
    cfg = vis.ViSConfig(num_outputs=16, input_dim=d, depth=6, nheads=heads, dim_f=hw,
                        dim_s=hw, dim_c=hw, num_clusters=K)
    takes, why = cuda_vis.kernel_takes(cfg, dtype)
    if not takes:
        raise AssertionError(f"vis_blocks_fused {heads} x {hw}: kernel_takes refuses: {why}")
    chunks, smalls, pos = cuda_vis.pack_vis_blocks(cfg, vis.init(cfg, g), getattr(torch, dtype))
    x = torch.randn((K, d), generator=g, device=dev)
    kw = dict(depth=cfg.depth, nheads=heads)
    run = lambda: cuda_vis.vis_blocks_fused(x, pos, chunks, smalls, **kw)  # noqa: E731
    before = _build.LAUNCHES["vis_blocks_fused"]
    out = run()
    launches = _build.LAUNCHES["vis_blocks_fused"] - before
    plain = (cuda_vis.vis_blocks_split_plain if dtype == "bfloat16"
             else cuda_vis.vis_blocks_plain)
    want = plain(x, pos, chunks, smalls, **kw)
    res = compare(torch, "vis_blocks_fused", dtype, out, want)
    if dtype == "float32":
        res.update(f64_errors(torch, out, want, cuda_vis.vis_blocks_plain(
            x.double(), pos.double(), chunks.double(), smalls.double(), **kw)))
    return {"heads": heads, "head_width": hw, "P": d // 2, "depth": cfg.depth, "tokens": K,
            **res, "launches_per_call": launches, "ms": time_ms(torch, run, 10)}


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def pearson(np, a, b) -> float:
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def models(torch, dev):
    """Random ResNet-50 and 5-fold ViS weights at full width, from seeds."""
    from sequoia_tpu_torch.models import resnet, vis

    rparams = resnet.random_params(torch.Generator(device=dev).manual_seed(0))
    vcfg = vis.ViSConfig(num_outputs=GENES, input_dim=D, depth=6, nheads=16, dim_f=64,
                         dim_s=64, dim_c=64, num_clusters=K, compute_dtype="bfloat16")
    folds = [(vcfg, vis.init(vcfg, torch.Generator(device=dev).manual_seed(100 + i)))
             for i in range(FOLDS)]
    return rparams, folds


def check_launched(launches: dict, kernels, path: str) -> None:
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{path} did not launch {missing}")


def main_path(torch, dev, rparams, folds) -> tuple[dict, dict]:
    """Phase 4; returns the kernels' launch counts of the kernel path's run
    and those of its 4096-patch slide."""
    import numpy as np
    from sequoia_tpu_torch import _build
    from sequoia_tpu_torch.models import resnet
    from sequoia_tpu_torch.ops import kmeans as km
    from sequoia_tpu_torch.pipeline.features import FeatureExtractor
    from sequoia_tpu_torch.serve import SlidePredictor

    g = torch.Generator(device=dev).manual_seed(6)
    slides = {n: torch.randint(0, 256, (n, PATCH, PATCH, 3), generator=g, device=dev,
                               dtype=torch.uint8) for n in (PATCHES, SMALL_SLIDE)}

    def predictor(kernels: bool) -> SlidePredictor:
        rcfg = resnet.ResNetConfig(compute_dtype=torch.bfloat16, early_pallas=kernels)
        ext = FeatureExtractor("resnet", rparams, batch_size=FEAT_BATCH, cfg=rcfg, device=dev)
        return SlidePredictor(ext, folds, n_clusters=K, use_pallas_kmeans=kernels,
                              use_fused_vis=kernels, device=dev)

    fast, plain = predictor(True), predictor(False)
    for p in (fast, plain):  # warm-up: cuDNN plans, allocator
        p.predict_patches(slides[SMALL_SLIDE])
    torch.cuda.synchronize()

    preds, secs, per_slide = {}, {}, {}
    _build.reset_launches()
    for n, u8 in slides.items():
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        preds[n] = fast.predict_patches(u8)
        torch.cuda.synchronize()
        secs[n] = time.perf_counter() - t0
        per_slide[n] = {k: _build.LAUNCHES[k] - before[k] for k in before}
    launches = dict(_build.LAUNCHES)
    check_launched(launches, ("stem16", "bottleneck_chain_cp", "vis_blocks_fused",
                              "lloyd_stats"), "main path")

    for n, u8 in slides.items():
        y = preds[n]
        if y.shape != (1, GENES) or not np.isfinite(y).all():
            raise AssertionError(f"{n}-patch slide: prediction {y.shape}, finite="
                                 f"{bool(np.isfinite(y).all())}")
        t0 = time.perf_counter()
        ref = plain.predict_patches(u8)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        # stage by stage on shared inputs, so a k-means label flip in one
        # path does not hide a kernel fault: features, then ViS on one set of
        # cluster features
        f_fast, f_plain = fast.extractor.features(u8), plain.extractor.features(u8)
        feat_rel = float((f_fast - f_plain).abs().max() / f_plain.abs().max())
        cf = plain.cluster(f_plain)
        vis_r = pearson(np, fast.predict_cluster_features(cf),
                        plain.predict_cluster_features(cf))
        r = pearson(np, y, ref)
        rel = float(np.abs(y - ref).max() / np.abs(ref).max())
        emit({"phase": "main_path", "patches": n, "shape": list(y.shape), "finite": True,
              "seconds": secs[n], "plain_seconds": plain_s, "launches": per_slide[n],
              "pearson_r_vs_plain": r, "max_rel_diff_vs_plain": rel,
              "features_max_rel_diff": feat_rel, "vis_pearson_r_same_clusters": vis_r})
        if vis_r < 0.999 or feat_rel > 0.05 or r < 0.99:
            raise AssertionError(f"{n}-patch slide disagrees with the plain path")

    # where a slide's time goes: one extractor batch traced, then each stage
    # of predict_patches alone, host clock around work that ends in a
    # synchronize
    u8 = slides[PATCHES]
    for label, p in (("kernels", fast), ("plain", plain)):
        emit({"phase": "profile", "path": "from_patches", "predictor": label,
              "batch": FEAT_BATCH, **profile_batch(torch, lambda p=p: p.extractor.raw_fwd(
                  p.extractor.params, u8[:FEAT_BATCH]))})
    for label, p in (("kernels", fast), ("plain", plain)):
        stages = {}

        def stage(key, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            stages[key] = time.perf_counter() - t0
            return out

        f = stage("features_s", p.extractor.features, u8)
        cf = stage("kmeans_s", p.cluster, f)
        # kmeans++ seeding + final assignment alone (no Lloyd step): the rest
        # of kmeans_s is the Lloyd loop, one host sync per step
        mask = torch.ones((f.shape[0],), dtype=torch.bool, device=dev)
        stage("kmeans_seeding_s", km.kmeans_fit, f, mask,
              torch.Generator(device=dev).manual_seed(0), K, 0)
        stage("vis_folds_s", p.predict_cluster_features, cf)
        gen = lambda: torch.Generator(device=dev).manual_seed(p.kmeans_seed)  # noqa: E731
        # the steps of the fit p.cluster ran (kmeans_fit draws the same seeding)
        steps = km.kmeans_fit(f.float(), mask, gen(), K, use_pallas=p.use_pallas)[3]
        # K5, plain f32 and plain f64 on this path's features from that
        # seeding: the count follows near-ties in the distances
        runs = lloyd_backends(torch, km, f.float(), mask,
                              km._plusplus_init(gen(), f.float(), mask, K))
        emit({"phase": "stages", "path": label, "patches": PATCHES, **stages,
              "lloyd_steps": steps,
              "lloyd_steps_by_backend": {k: r["steps"] for k, r in runs.items()},
              "labels_equal_f64_by_backend": {k: r["labels_equal_f64"]
                                              for k, r in runs.items()}})
    return launches, per_slide[PATCHES]


def main_path_f32(torch, dev, rparams, folds) -> tuple[dict, dict]:
    """Phase 4's f32 leg, on phase 4's 4096-patch slide: the slide program
    (``make_slide_program``, compute_dtype f32, fold 0) with the kernels
    against without, then ``SlidePredictor`` at ``ResNetConfig(f32,
    early_pallas=True)`` with the five folds in f32 against the plain
    predictor, stage by stage; returns the kernels' launch counts of both
    kernel runs, and those of ``predict_patches`` alone."""
    import numpy as np
    from sequoia_tpu_torch import _build
    from sequoia_tpu_torch.models import resnet
    from sequoia_tpu_torch.pipeline.features import FeatureExtractor
    from sequoia_tpu_torch.pipeline.fused import make_slide_program
    from sequoia_tpu_torch.serve import SlidePredictor

    f32, kernels = torch.float32, ("stem16", "bottleneck_chain_cp", "lloyd_stats",
                                   "vis_blocks_fused")
    ffolds = [(dataclasses.replace(cfg, compute_dtype="float32"), p) for cfg, p in folds]
    g = torch.Generator(device=dev).manual_seed(6)  # main_path's first slide
    u8 = torch.randint(0, 256, (PATCHES, PATCH, PATCH, 3), generator=g, device=dev,
                       dtype=torch.uint8)
    batches = u8.reshape(PATCHES // FEAT_BATCH, FEAT_BATCH, PATCH, PATCH, 3)
    gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731

    def timed(fn, *args):
        _build.reset_launches()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(_build.LAUNCHES)

    total = dict.fromkeys(_build.LAUNCHES, 0)
    progs = {on: make_slide_program(rparams, *ffolds[0], n_clusters=K, compute_dtype=f32,
                                    kernels=on, device=dev) for on in (True, False)}
    for prog in progs.values():  # warm-up: cuDNN plans, allocator
        prog(batches[:1], gen())
    (y, secs, counts), (ref, plain_s, plain_counts) = (timed(progs[on], batches, gen())
                                                      for on in (True, False))
    check_launched(counts, kernels, "f32 slide program")
    if any(plain_counts.values()):
        raise AssertionError(f"the plain f32 slide program launched {plain_counts}")
    y, ref = y.cpu().numpy(), ref.cpu().numpy()
    r = pearson(np, y, ref)
    emit({"phase": "main_path_f32", "entry": "make_slide_program", "patches": PATCHES,
          "shape": list(y.shape), "finite": bool(np.isfinite(y).all()), "seconds": secs,
          "plain_seconds": plain_s, "launches": counts, "pearson_r_vs_plain": r,
          "max_rel_diff_vs_plain": float(np.abs(y - ref).max() / np.abs(ref).max())})
    if y.shape != (GENES,) or not np.isfinite(y).all() or r < 0.99:
        raise AssertionError("the f32 slide program disagrees with the plain program")
    total = {k: total[k] + counts[k] for k in total}

    def predictor(on: bool) -> SlidePredictor:
        rcfg = resnet.ResNetConfig(compute_dtype=f32, early_pallas=on)
        ext = FeatureExtractor("resnet", rparams, batch_size=FEAT_BATCH, cfg=rcfg, device=dev)
        return SlidePredictor(ext, ffolds, n_clusters=K, use_pallas_kmeans=on,
                              use_fused_vis=on, device=dev)

    fast, plain = predictor(True), predictor(False)
    for p in (fast, plain):
        p.predict_patches(u8[:SMALL_SLIDE])
    (y, secs, counts), (ref, plain_s, _) = (timed(p.predict_patches, u8)
                                            for p in (fast, plain))
    check_launched(counts, kernels, "f32 predict_patches")
    f_fast, f_plain = fast.extractor.features(u8), plain.extractor.features(u8)
    feat_rel = float((f_fast - f_plain).abs().max() / f_plain.abs().max())
    cf = plain.cluster(f_plain)
    vis_r = pearson(np, fast.predict_cluster_features(cf), plain.predict_cluster_features(cf))
    r = pearson(np, y, ref)
    emit({"phase": "main_path_f32", "entry": "predict_patches", "patches": PATCHES,
          "shape": list(y.shape), "finite": bool(np.isfinite(y).all()), "seconds": secs,
          "plain_seconds": plain_s, "launches": counts, "pearson_r_vs_plain": r,
          "max_rel_diff_vs_plain": float(np.abs(y - ref).max() / np.abs(ref).max()),
          "features_max_rel_diff": feat_rel, "features_tol": STAGE_FEAT_TOL["float32"],
          "vis_pearson_r_same_clusters": vis_r})
    if (y.shape != (1, GENES) or not np.isfinite(y).all() or vis_r < 0.999
            or feat_rel > STAGE_FEAT_TOL["float32"] or r < 0.99):
        raise AssertionError("the f32 4096-patch slide disagrees with the plain path")
    total = {k: total[k] + counts[k] for k in total}
    del f_fast, f_plain
    for label, p in (("kernels", fast), ("plain", plain)):
        emit({"phase": "profile", "path": "from_patches", "dtype": "float32", "predictor": label,
              "batch": FEAT_BATCH, **profile_batch(torch, lambda p=p: p.extractor.raw_fwd(
                  p.extractor.params, u8[:FEAT_BATCH]))})
    return total, counts


# ---------------------------------------------------------------------------
# phase 5: serving from a whole-slide image
# ---------------------------------------------------------------------------

def make_slide(torch, dev, seed: int, side: int = WSI_SIDE):
    """A synthetic AppMag-20 slide: a ``side`` x ``side`` (8192) level 0 of background
    (242) with a textured tissue ellipse over about 75% of it (the colour
    and texture of tests/test_pipeline_e2e.synthetic_wsi), and a 4x-down
    level 1, built on the card from a seed and held on the host."""
    from sequoia_tpu_torch.data.wsi import ArrayReader

    g = torch.Generator(device=dev).manual_seed(seed)
    n = side
    ys = torch.arange(n, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(n, device=dev, dtype=torch.float32)[None, :]
    ellipse = ((ys - n * (0.5 + 0.01 * seed)) / (0.5 * n)) ** 2 + (
        (xs - n / 2) / (0.49 * n)) ** 2 < 1
    tex = torch.randint(-40, 40, (n, n, 3), generator=g, device=dev, dtype=torch.int16)
    tissue = (torch.tensor([188, 105, 160], dtype=torch.int16, device=dev) + tex
              ).clamp(0, 255).to(torch.uint8)
    lv0 = torch.where(ellipse[..., None], tissue, torch.full_like(tissue, 242))
    levels = [lv0.cpu().numpy(), lv0[::4, ::4].cpu().numpy()]
    return ArrayReader(levels, properties={"aperio.AppMag": "20"})


def wsi_path(torch, dev, rparams, folds) -> tuple[dict, list, dict]:
    """Phase 5; returns the kernels' launch counts of the kernel path's run,
    each slide's kept patch count and the first slide's launch counts."""
    import numpy as np
    from sequoia_tpu_torch import _build
    from sequoia_tpu_torch.models import resnet
    from sequoia_tpu_torch.ops import masking
    from sequoia_tpu_torch.pipeline import patch_gen
    from sequoia_tpu_torch.pipeline.features import FeatureExtractor
    from sequoia_tpu_torch.serve import SlidePredictor

    slides = [make_slide(torch, dev, s) for s in (1, 2)]

    def predictor(kernels: bool, **kw) -> SlidePredictor:
        rcfg = resnet.ResNetConfig(compute_dtype=torch.bfloat16,
                                   fused_stages=(1, 2, 3, 4) if kernels else ())
        ext = FeatureExtractor("resnet", rparams, batch_size=FEAT_BATCH, cfg=rcfg,
                               patch_size=PATCH, device=dev)
        return SlidePredictor(ext, folds, n_clusters=K, use_pallas_kmeans=kernels,
                              use_fused_vis=kernels, patch_size=PATCH, device=dev, **kw)

    def capture(p) -> list:
        """Record the kept features each predict_features call receives."""
        seen, orig = [], p.predict_features

        def spy(feats):
            seen.append(feats)
            return orig(feats)

        p.predict_features = spy
        return seen

    fast, plain = predictor(True), predictor(False)
    warm = torch.randint(0, 256, (SMALL_SLIDE, PATCH, PATCH, 3), device=dev,
                         dtype=torch.uint8, generator=torch.Generator(device=dev).manual_seed(7))
    for p in (fast, plain):  # warm-up: cuDNN plans for channels_last, allocator
        p.predict_patches(warm)
    n_cands = [len(fast._candidates(s)[1]) for s in slides]
    torch.cuda.synchronize()

    def serve(p, label: str) -> dict:
        feats = capture(p)
        out = {"preds": [], "seconds": [], "kept": [], "launches": []}
        for s in slides:
            before, kept0 = dict(_build.LAUNCHES), p.io_stats["kept"]
            t0 = time.perf_counter()
            out["preds"].append(p.predict_wsi(s))
            torch.cuda.synchronize()
            out["seconds"].append(time.perf_counter() - t0)
            out["kept"].append(p.io_stats["kept"] - kept0)
            out["launches"].append({k: _build.LAUNCHES[k] - before[k] for k in before})
        t0 = time.perf_counter()
        out["slides"] = list(p.predict_slides(slides))
        torch.cuda.synchronize()
        out["slides_seconds"] = time.perf_counter() - t0
        out["feats"] = feats[:len(slides)]
        del p.predict_features
        return out

    _build.reset_launches()
    got = serve(fast, "kernels")
    launches = dict(_build.LAUNCHES)
    check_launched(launches, ("bottleneck_chain", "lloyd_stats", "vis_blocks_fused"),
                   "WSI path")
    ref = serve(plain, "plain")

    for i in range(len(slides)):
        y, want = got["preds"][i], ref["preds"][i]
        if y.shape != (1, GENES) or not np.isfinite(y).all():
            raise AssertionError(f"WSI slide {i}: prediction {y.shape} not finite (1, G)")
        fa, fb = got["feats"][i], ref["feats"][i]
        feat_rel = float((fa - fb).abs().max() / fb.abs().max())
        r = pearson(np, y, want)
        r_slides = pearson(np, got["slides"][i][1], y)
        emit({"phase": "wsi", "slide": i, "level0": [WSI_SIDE, WSI_SIDE],
              "candidates": n_cands[i], "kept": got["kept"][i], "kept_plain": ref["kept"][i],
              "seconds": got["seconds"][i], "plain_seconds": ref["seconds"][i],
              "launches": got["launches"][i], "features_max_rel_diff": feat_rel,
              "pearson_r_vs_plain": r, "pearson_r_predict_slides_vs_wsi": r_slides})
        if got["kept"][i] != ref["kept"][i] or not 0 < got["kept"][i] <= n_cands[i]:
            raise AssertionError(f"WSI slide {i}: kept {got['kept'][i]} vs plain "
                                 f"{ref['kept'][i]} of {n_cands[i]} candidates")
        if feat_rel > 0.05 or r < 0.99 or r_slides < 0.99:
            raise AssertionError(f"WSI slide {i} disagrees with the plain path")

    # decoding stops once max_patches are kept
    capped = predictor(True, max_patches=WSI_CAP)
    decoded, orig = [], capped._decode_chunks

    def counting(candidates, decode_chunk=64, stop=None):
        for chunk in orig(candidates, decode_chunk, stop):
            decoded.append(len(chunk))
            yield chunk

    capped._decode_chunks = counting
    y = capped.predict_wsi(slides[0])
    if capped.io_stats["kept"] != WSI_CAP or sum(decoded) >= n_cands[0]:
        raise AssertionError(f"max_patches={WSI_CAP}: kept {capped.io_stats['kept']}, "
                             f"decoded {sum(decoded)} of {n_cands[0]} candidates")
    # where a slide's time goes: the slide mask + candidate grid, then per
    # batch of candidates the tissue screen and the backbone alone
    t0 = time.perf_counter()
    cands = fast._candidates(slides[0])
    torch.cuda.synchronize()
    mask_s = time.perf_counter() - t0
    batch = torch.as_tensor(next(fast._decode_chunks(cands, FEAT_BATCH)), device=dev)
    screen_ms = time_ms(torch, lambda: masking.patch_keep_flags(
        batch, background_threshold=patch_gen.BACKGROUND_THRESHOLD), 5)
    backbone_ms = {label: time_ms(torch, lambda p=p: p.extractor.raw_fwd(
        p.extractor.params, batch), 3) for label, p in (("kernels", fast), ("plain", plain))}
    for label, p in (("kernels", fast), ("plain", plain)):
        emit({"phase": "profile", "path": "wsi", "predictor": label, "batch": FEAT_BATCH,
              **profile_batch(torch, lambda p=p: p.extractor.raw_fwd(p.extractor.params,
                                                                     batch))})
    emit({"phase": "wsi_summary", "slides": len(slides),
          "seconds_per_slide": sum(got["seconds"]) / len(slides),
          "plain_seconds_per_slide": sum(ref["seconds"]) / len(slides),
          "predict_slides_seconds": got["slides_seconds"],
          "plain_predict_slides_seconds": ref["slides_seconds"],
          "bottleneck_chain_launches_per_slide": [
              lc["bottleneck_chain"] for lc in got["launches"]],
          "mask_and_grid_s": mask_s, "screen_ms_per_batch": screen_ms,
          "backbone_ms_per_batch": backbone_ms, "batch": FEAT_BATCH,
          "capped_run": {"max_patches": WSI_CAP, "kept": capped.io_stats["kept"],
                         "decoded": sum(decoded), "candidates": n_cands[0],
                         "finite": bool(np.isfinite(y).all())}})
    return launches, got["kept"], got["launches"][0]


# ---------------------------------------------------------------------------
# phase 6: serving trained folds from files (checkpoints, the CLI, HTTP)
# ---------------------------------------------------------------------------

def write_slide_file(slide, path: str, writer: str) -> None:
    """An ArrayReader slide as a file: a tiled TIFF through the native
    reader's writer, or a TIFF of one uncompressed page per level through
    Pillow (read back by ``data/wsi.PILReader``)."""
    if writer == "native":
        from sequoia_tpu_torch import native

        native.write_tiled_tiff(path, slide.levels, tile=(256, 256),
                                description="synthetic|AppMag = 20")
    else:
        from PIL import Image

        Image.fromarray(slide.levels[0]).save(
            path, save_all=True, append_images=[Image.fromarray(lv) for lv in slide.levels[1:]])


def read_csv(path: str):
    """The serve CLI's CSV -> (header, slide names, (slides, genes) values)."""
    import csv

    import numpy as np

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], np.asarray(
        [[float(v) for v in r[1:]] for r in rows[1:]])


def http_checks(torch, np, pred, genes, paths, want) -> dict:
    """``http_serve`` on a loopback port over ``pred``: GET /healthz and
    /genes; with ``want`` (slide path -> its CLI row) a POST of every slide
    held in the pipeline while two more POSTs queue, which must merge into
    one run, each answer against the CLI's rows; then a POST of a path that
    cannot be opened, which must give 502 with the error."""
    import threading
    import urllib.error
    import urllib.request

    from sequoia_tpu_torch import http_serve

    runs, release = [], threading.Event()
    orig = pred.predict_slides

    def spy(paths_, on_error=None):
        runs.append(tuple(paths_))
        if len(runs) == 1 and want:
            release.wait(120)  # the first run holds until the next two POSTs queue
        return orig(paths_, on_error=on_error)

    pred.predict_slides = spy
    svc = http_serve.PredictorService(pred, genes)
    srv = http_serve.make_server(svc, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = "http://127.0.0.1:%d" % srv.server_address[1]

    def post(obj, out=None):
        req = urllib.request.Request(base + "/predict", data=json.dumps(obj).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                res = (r.status, json.loads(r.read()))
        except urllib.error.HTTPError as e:
            res = (e.code, json.loads(e.read()))
        if out is not None:
            out.append(res)
        return res

    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(base + "/genes", timeout=60) as r:
            listed = json.loads(r.read())
        if health["status"] != "ok" or health["folds"] != FOLDS or listed["n"] != len(genes):
            raise AssertionError(f"http: /healthz {health}, /genes n={listed['n']}")
        res = {"healthz": health["status"], "genes_n": listed["n"]}
        if want:
            res.update(merge_checks(np, svc, runs, release, post, genes, paths, want))
        code, out = post({"wsi": "/nonexistent/slide.svs"})
        if code != 502 or not out["failed"] or out["predictions"]:
            raise AssertionError(f"http: unopenable slide gave {code} {out}")
        res["unopenable_post"] = {"code": code, "error": list(out["failed"].values())[0]}
        return res
    finally:
        release.set()
        srv.shutdown()
        srv.server_close()
        svc.close()
        del pred.predict_slides


def merge_checks(np, svc, runs, release, post, genes, paths, want) -> dict:
    """A POST of every slide held in the pipeline (``runs`` records each
    run; the first waits on ``release``) while two more POSTs queue: they
    must run as one merged run, and every answer must match ``want``."""
    import threading

    outs: list = []
    first = threading.Thread(target=post, args=({"wsi": paths}, outs))
    first.start()
    deadline = time.monotonic() + 60
    while not runs:
        if time.monotonic() > deadline:
            raise AssertionError("http: the first POST never reached the pipeline")
        time.sleep(0.01)
    queued = [threading.Thread(target=post, args=({"wsi": paths[i:] + paths[:i]}, outs))
              for i in range(2)]
    for t in queued:
        t.start()
    while svc.health()["pending_slides"] < 3 * len(paths):
        if time.monotonic() > deadline:
            raise AssertionError("http: the two POSTs never queued")
        time.sleep(0.01)
    release.set()
    for t in (first, *queued):
        t.join(600)
    if len(runs) != 2 or sorted(runs[1]) != sorted(paths):
        raise AssertionError(f"http: the two queued POSTs ran as {runs[1:]}, not one run")
    r_min = 1.0
    for code, out in outs:
        if code != 200 or out["failed"] or sorted(out["predictions"]) != sorted(paths):
            raise AssertionError(f"http: POST gave {code}, failed {out['failed']}")
        for p in paths:
            got = np.asarray([out["predictions"][p][g] for g in genes])
            r_min = min(r_min, pearson(np, got, want[p]))
    if r_min < 0.99999:
        raise AssertionError(f"http: predictions r = {r_min} against the CLI's rows")
    return {"posts": len(outs), "pipeline_runs": len(runs),
            "merged_run_slides": len(runs[1]), "pearson_r_min_vs_cli": r_min}


def serve_cli_path(torch, dev, folds) -> dict:
    """Phase 6: the five folds written as the reference's files (``.pt`` CV
    directory with ``test_results.pkl``, fold 0 again as an HF directory),
    loaded back bit for bit, then served from slide files by
    ``cli.serve.main`` (full head, a panel, and plain) and by the HTTP
    server, with the kernel set of ``cli.serve.build_predictor``.  The files
    are written through the native reader's writer where it built, else
    through Pillow where it is installed; with neither, only the in-memory
    slides are served (``predict_slides``) and HTTP gets GETs and a path that
    cannot be opened.  Returns the launch counts of the kernel runs."""
    import pickle
    import shutil
    import tempfile

    import numpy as np
    from sequoia_tpu_torch import _build, native
    from sequoia_tpu_torch.cli import serve as cli
    from sequoia_tpu_torch.models import convert
    from sequoia_tpu_torch.train import checkpoint

    genes = [f"GENE{i:05d}" for i in range(GENES)]
    panel = genes[::GENES // PANEL][:PANEL]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        t0 = time.perf_counter()
        exp, hf = os.path.join(tmp, "exp"), os.path.join(tmp, "hf")
        for i, (cfg, params) in enumerate(folds):
            checkpoint.save_torch_state_dict(convert.vis_to_torch(cfg, params),
                                             os.path.join(exp, f"model_best_{i}.pt"))
        with open(os.path.join(exp, "test_results.pkl"), "wb") as f:
            pickle.dump({"genes": genes}, f)
        checkpoint.save_hf_vis_layout(hf, *folds[0])
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = cli.load_fold_models(exp)
        load_s = time.perf_counter() - t0
        loaded_hf = cli.load_fold_models(hf)

        def leaves(params):
            return {**{k: v for k, v in params.items() if k != "blocks"}, **params["blocks"]}

        for (cfg, mem), (lcfg, got) in zip(folds + folds[:1], loaded + loaded_hf):
            want, have = leaves(mem), leaves(got)
            if lcfg != dataclasses.replace(cfg, compute_dtype=None) or set(have) != set(want) \
                    or not all(torch.equal(have[k], want[k].cpu()) for k in want):
                raise AssertionError("serve_cli: a fold loaded from file differs from memory")
        emit({"phase": "serve_cli_checkpoints", "folds": len(loaded), "genes": GENES,
              "bytes": sum(os.path.getsize(os.path.join(d, n)) for d in (exp, hf)
                           for n in os.listdir(d)),
              "write_seconds": write_s, "load_seconds": load_s,
              "hf_files": sorted(os.listdir(hf)), "bit_equal": True})

        # the CLI serves the folds in its --compute_dtype
        models = [(dataclasses.replace(cfg, compute_dtype="bfloat16"), p) for cfg, p in loaded]
        kw = dict(device=dev, batch_size=FEAT_BATCH, n_clusters=K, patch_size=PATCH)
        fast, line = cli.build_predictor("resnet", "random", models, **kw)
        plain, _ = cli.build_predictor("resnet", "random", models, kernels=(), **kw)
        slides = [make_slide(torch, dev, s) for s in (1, 2)]
        warm = torch.randint(0, 256, (SMALL_SLIDE, PATCH, PATCH, 3), device=dev, dtype=torch.uint8,
                             generator=torch.Generator(device=dev).manual_seed(7))
        for p in (fast, plain):
            p.predict_patches(warm)
        torch.cuda.synchronize()

        built = native.available()
        try:
            import PIL  # noqa: F401

            pillow = True
        except ImportError:
            pillow = False
        writer = "native" if built else "pillow" if pillow else None
        emit({"phase": "native_reader", "available": built, "error": native.build_error(),
              "slide_files_by": writer or "none (in-memory slides)"})

        def timed(p, items):
            t0 = time.perf_counter()
            out = dict(p.predict_slides(items))
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        _build.reset_launches()
        mem_rows, mem_s = timed(fast, slides)
        launches = dict(_build.LAUNCHES)
        plain_rows, plain_s = timed(plain, slides)
        r_mem = min(pearson(np, mem_rows[s], plain_rows[s]) for s in slides)
        res = {"phase": "serve_cli", "kernels_line": line, "slide_files_by": writer,
               "in_memory": {"seconds_per_slide": mem_s / len(slides),
                             "plain_seconds_per_slide": plain_s / len(slides),
                             "pearson_r_min_vs_plain": r_min_check(r_mem, 0.99)}}
        if writer is None:
            res["http"] = http_checks(torch, np, fast, genes, [], None)
            emit(res)
            check_launched(launches, ("bottleneck_chain", "lloyd_stats", "vis_blocks_fused"),
                           "serve_cli path")
            return launches

        paths = [os.path.join(tmp, f"slide{i}.tiff") for i in range(len(slides))]
        t0 = time.perf_counter()
        for slide, path in zip(slides, paths):
            write_slide_file(slide, path, writer)
        res["slide_write_seconds"] = time.perf_counter() - t0
        args = ["--wsi", *paths, "--checkpoints", exp, "--weights", "random",
                "--batch_size", str(FEAT_BATCH), "--num_clusters", str(K),
                "--patch_size", str(PATCH), "--compute_dtype", "bfloat16", "--device", dev.type]
        # the CLI once to warm the host (the first read of each file, the
        # first decoded page), then in turns (kernels, plain, plain, kernels:
        # the host clock drifts within a call), then once with the panel
        runs: dict = {}
        order = (("warm_up", []), ("kernels", []), ("plain", ["--kernels", "off"]),
                 ("plain", ["--kernels", "off"]), ("kernels", []),
                 ("panel", ["--panel", ",".join(panel)]))
        for i, (name, extra) in enumerate(order):
            if name != "plain":
                _build.reset_launches()
            t0 = time.perf_counter()
            out = cli.main([*args, *extra, "--out", os.path.join(tmp, f"{name}{i}.csv")])
            torch.cuda.synchronize()
            runs.setdefault(name, []).append({**out, "main_seconds": time.perf_counter() - t0,
                                              "csv": read_csv(out["out"])})
            if name != "plain":
                launches = {k: launches[k] + v for k, v in _build.LAUNCHES.items()}
        names = [os.path.basename(p) for p in paths]
        for name, want_genes in (("warm_up", genes), ("kernels", genes), ("panel", panel),
                                 ("plain", genes)):
            for run in runs[name]:
                header, rows, vals = run["csv"]
                if header != ["wsi_file_name", *want_genes] or rows != names \
                        or vals.shape != (len(paths), len(want_genes)) \
                        or not np.isfinite(vals).all():
                    raise AssertionError(f"serve_cli: {name} CSV {vals.shape}, rows {rows}")
        full, part = runs["kernels"][0]["csv"][2], runs["panel"][0]["csv"][2]
        cols = full[:, [genes.index(g) for g in panel]]
        panel_rel = float(np.abs(part - cols).max() / np.abs(cols).max())
        if panel_rel > 1e-5:
            raise AssertionError(f"serve_cli: panel columns {panel_rel:.3g} from the full run's")
        # the CLI's rows against the predictor's predict_wsi on the in-memory slides
        direct = [fast.predict_wsi(s)[0] for s in slides]
        r_direct = r_min_check(min(pearson(np, full[i], direct[i]) for i in range(len(slides))),
                               0.99999)
        r_plain = r_min_check(min(pearson(np, full[i], runs["plain"][0]["csv"][2][i])
                                  for i in range(len(slides))), 0.99)
        per_slide = {k: [r["serve_seconds"] / r["slides"] for r in v] for k, v in runs.items()}
        mean = {k: sum(v) / len(v) for k, v in per_slide.items()}
        # where a file slide's extra time goes: the slide mask and candidate
        # grid, then decoding every candidate, from the file and from memory
        decode = {}
        for label, src in (("file", paths[0]), ("memory", slides[0])):
            t0 = time.perf_counter()
            cands = fast._candidates(src)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            n = sum(len(c) for c in fast._decode_chunks(cands))
            decode[label] = {"mask_and_grid_s": t1 - t0, "decode_s": time.perf_counter() - t1,
                             "candidates": n}
        res.update(
            csv_shape=list(full.shape), panel_shape=list(part.shape),
            panel_max_rel_diff=panel_rel, pearson_r_min_vs_predict_wsi=r_direct,
            pearson_r_min_vs_plain=r_plain, seconds_per_slide=mean["kernels"],
            plain_seconds_per_slide=mean["plain"], panel_seconds_per_slide=mean["panel"],
            seconds_per_slide_by_run=per_slide, slides_per_hour=3600 / mean["kernels"],
            plain_slides_per_hour=3600 / mean["plain"],
            main_seconds={k: [r["main_seconds"] for r in v] for k, v in runs.items()},
            slide_file_host_work=decode,
            http=http_checks(torch, np, fast, genes, paths,
                             {p: full[i] for i, p in enumerate(paths)}))
        res["float32"] = serve_cli_f32(torch, np, cli, exp, paths[0], tmp)
        launches = {k: launches[k] + v for k, v in res["float32"]["launches"].items()}
        emit(res)
        check_launched(launches, ("bottleneck_chain", "lloyd_stats", "vis_blocks_fused"),
                       "serve_cli path")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def serve_cli_f32(torch, np, cli, exp: str, path: str, tmp: str) -> dict:
    """One slide file through ``cli.serve --compute_dtype float32`` (the JAX
    CLI's f32 fold numerics): K4 and K1 as 3xTF32 tensor-core kernels and
    K5, against ``--kernels off`` on the same file, held at phase 12's f32
    tolerance; the kernel run must launch all three, the plain one none."""
    from sequoia_tpu_torch import _build

    args = ["--wsi", path, "--checkpoints", exp, "--weights", "random", "--batch_size",
            str(FEAT_BATCH), "--num_clusters", str(K), "--patch_size", str(PATCH),
            "--compute_dtype", "float32", "--device", "cuda"]
    runs = {}
    for name, extra in (("kernels", []), ("plain", ["--kernels", "off"])):
        _build.reset_launches()
        t0 = time.perf_counter()
        out = cli.main([*args, *extra, "--out", os.path.join(tmp, f"f32_{name}.csv")])
        torch.cuda.synchronize()
        runs[name] = {"main_seconds": time.perf_counter() - t0,
                      "seconds_per_slide": out["serve_seconds"] / out["slides"],
                      "y": read_csv(out["out"])[2], "launches": dict(_build.LAUNCHES)}
    y, want = runs["kernels"]["y"], runs["plain"]["y"]
    res = {"kernels_launches": runs["kernels"]["launches"],
           "plain_launches": runs["plain"]["launches"],
           "seconds_per_slide": runs["kernels"]["seconds_per_slide"],
           "plain_seconds_per_slide": runs["plain"]["seconds_per_slide"],
           "main_seconds": {k: r["main_seconds"] for k, r in runs.items()},
           "max_abs_diff_vs_plain": float(np.abs(y - want).max()),
           "pearson_r_vs_plain": pearson(np, y, want), "rtol": RAW_RTOL, "atol": RAW_ATOL,
           "launches": runs["kernels"]["launches"]}
    check_launched(res["kernels_launches"], ("bottleneck_chain", "lloyd_stats",
                                             "vis_blocks_fused"), "serve_cli f32")
    if any(res["plain_launches"].values()):
        raise AssertionError(f"serve_cli f32: --kernels off launched {res['plain_launches']}")
    if y.shape != want.shape or not np.isfinite(y).all() or not np.allclose(
            y, want, rtol=RAW_RTOL, atol=RAW_ATOL):
        raise AssertionError(f"serve_cli f32: kernels differ from plain: {res}")
    return res


# ---------------------------------------------------------------------------
# phase 7: the UNI backbone
# ---------------------------------------------------------------------------

def uni_flops(cfg) -> int:
    """Multiply-add operations x 2 of one image through the ViT: the patch
    embed, then per block qkv, scores, probabilities . V, proj, fc1, fc2."""
    n, d, m, pdim = cfg.tokens, cfg.dim, cfg.mlp_dim, cfg.patch_size ** 2 * 3
    block = 2 * n * d * (3 * d + d + 2 * m) + 2 * 2 * n * n * d
    return 2 * (n - 1) * pdim * d + cfg.depth * block


def uni_models(torch, dev):
    """Random UNI ViT-L/16 weights (LayerScale UNI_LAYER_SCALE) and five ViS
    folds of input UNI_DIM at the reference's 16 x 64, from seeds."""
    from sequoia_tpu_torch.models import uni_vit, vis

    params = uni_vit.random_params(uni_vit.UniViTConfig(),
                                   torch.Generator(device=dev).manual_seed(12),
                                   layer_scale=UNI_LAYER_SCALE)
    vcfg = vis.ViSConfig(num_outputs=GENES, input_dim=UNI_DIM, depth=6, nheads=16, dim_f=64,
                         dim_s=64, dim_c=64, num_clusters=K, compute_dtype="bfloat16")
    folds = [(vcfg, vis.init(vcfg, torch.Generator(device=dev).manual_seed(200 + i)))
             for i in range(FOLDS)]
    return params, folds


def uni_resize(torch, dev, u8) -> dict:
    """The Pillow-exact resize of one extractor batch on the card against
    the port's CPU result and Pillow's, bit for bit."""
    import numpy as np
    from sequoia_tpu_torch.ops import pil_resize

    got = pil_resize.resize_u8(u8, 224, 224)
    if not torch.equal(got.cpu(), pil_resize.resize_u8(u8.cpu(), 224, 224)):
        raise AssertionError("uni_resize: the card's resize differs from the CPU's")
    res = {"batch": list(u8.shape), "out": list(got.shape), "bit_equal_cpu": True,
           "ms": time_ms(torch, lambda: pil_resize.resize_u8(u8, 224, 224), 20)}
    try:
        from PIL import Image
    except ImportError:
        res["bit_equal_pillow"] = "not measured (no Pillow)"
        return res
    want = np.stack([np.asarray(Image.fromarray(im).resize((224, 224), Image.BILINEAR))
                     for im in u8.cpu().numpy()])
    if not np.array_equal(got.cpu().numpy(), want):
        raise AssertionError("uni_resize: the card's resize differs from Pillow's")
    res["bit_equal_pillow"] = True
    return res


def uni_batch(torch, dev, params, u8) -> dict:
    """One extractor batch of 128 through the bf16 ViT-L against the f32
    forward; ms per batch against the bound, the UNI_SCAN_CHUNK sweep, the
    f32 forward's time and a trace of one batch."""
    from sequoia_tpu_torch.models import uni_vit
    from sequoia_tpu_torch.pipeline.features import FeatureExtractor

    ext = {dt: FeatureExtractor("uni", params, batch_size=FEAT_BATCH, device=dev,
                                cfg=uni_vit.UniViTConfig(compute_dtype=dt))
           for dt in (torch.bfloat16, torch.float32)}
    fast, full = ext[torch.bfloat16], ext[torch.float32]
    f16, f32 = fast.raw_fwd(fast.params, u8), full.raw_fwd(full.params, u8)
    rel = float((f16 - f32).abs().max() / f32.abs().max())
    cos = float(torch.nn.functional.cosine_similarity(f16, f32, dim=1).min())
    spread = float((f32 - f32.mean(0)).abs().max() / f32.abs().max())
    if (f16.shape != (FEAT_BATCH, UNI_DIM) or not bool(torch.isfinite(f16).all())
            or rel > UNI_BF16_TOL):
        raise AssertionError(f"uni_batch: bf16 features {tuple(f16.shape)}, {rel:.3g} of max "
                             f"|f32| from the f32 forward (tol {UNI_BF16_TOL:g})")
    flops = uni_flops(fast.cfg) * FEAT_BATCH
    moved = nbytes(u8, f16) + sum(v.numel() * 2 for k, v in fast.params.items()
                                  if k != "blocks") + sum(
        v.numel() * 2 for v in fast.params["blocks"].values())
    bnd, by = bound_ms(moved, flops, "bfloat16")
    run = lambda: fast.raw_fwd(fast.params, u8)  # noqa: E731
    sweep = {}
    for ck in UNI_CHUNKS:
        fast.UNI_SCAN_CHUNK = ck
        sweep[ck] = time_ms(torch, run, 5)
    del fast.UNI_SCAN_CHUNK  # back to the class default
    ms = time_ms(torch, run, 5)
    res = {"batch": FEAT_BATCH, "bf16_vs_f32_max_rel": rel, "tol": UNI_BF16_TOL,
           "bf16_vs_f32_cosine_min": cos, "f32_spread_over_patches": spread,
           "scan_chunk_default": type(fast).UNI_SCAN_CHUNK, "ms": ms,
           "ms_by_scan_chunk": sweep, "f32_ms": time_ms(torch, lambda: full.raw_fwd(
               full.params, u8), 2),
           "tflop_per_batch": flops / 1e12, "bound_ms": bnd, "bound_by": by,
           "bound_share": bnd / ms, "tflops": flops / ms / 1e9}
    del ext, full, f32
    torch.cuda.empty_cache()
    res["profile"] = profile_batch(torch, run)
    return res


def uni_path(torch, dev, resnet_kept: list) -> dict:
    """Phase 7; returns the kernels' launch counts of the kernel runs (K5:
    from patches, from the WSI and through the CLI)."""
    import pickle
    import shutil
    import tempfile

    import numpy as np
    from sequoia_tpu_torch import _build
    from sequoia_tpu_torch.cli import serve as cli
    from sequoia_tpu_torch.models import convert, uni_vit
    from sequoia_tpu_torch.pipeline.features import FeatureExtractor
    from sequoia_tpu_torch.serve import SlidePredictor
    from sequoia_tpu_torch.train import checkpoint

    params, folds = uni_models(torch, dev)
    g = torch.Generator(device=dev).manual_seed(13)
    u8 = torch.randint(0, 256, (FEAT_BATCH, PATCH, PATCH, 3), generator=g, device=dev,
                       dtype=torch.uint8)
    emit({"phase": "uni_resize", **uni_resize(torch, dev, u8)})
    emit({"phase": "uni_batch", **uni_batch(torch, dev, params, u8)})
    emit({"phase": "uni_lloyd", "name": "lloyd_stats", "dtype": "float32",
          **check_lloyd_k(torch, dev, K, UNI_DIM)})

    ext = FeatureExtractor("uni", params, batch_size=FEAT_BATCH, device=dev,
                           cfg=uni_vit.UniViTConfig(compute_dtype=torch.bfloat16))
    del params
    torch.cuda.empty_cache()
    fast, plain = (SlidePredictor(ext, folds, n_clusters=K, use_pallas_kmeans=kern,
                                  patch_size=PATCH, device=dev) for kern in (True, False))
    slides = {n: torch.randint(0, 256, (n, PATCH, PATCH, 3), generator=g, device=dev,
                               dtype=torch.uint8) for n in (PATCHES, SMALL_SLIDE)}
    for p in (fast, plain):
        p.predict_patches(slides[SMALL_SLIDE])
    torch.cuda.synchronize()

    def timed(fn, *args):
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {k: _build.LAUNCHES[k] - before[k] for k in before}

    _build.reset_launches()
    launches = dict.fromkeys(_build.LAUNCHES, 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    for n, patches in slides.items():
        y, secs, lc = timed(fast.predict_patches, patches)
        add(lc)
        ref, plain_s, _ = timed(plain.predict_patches, patches)
        if y.shape != (1, GENES) or not np.isfinite(y).all() or lc["lloyd_stats"] == 0:
            raise AssertionError(f"uni {n}-patch slide: {y.shape}, launches {lc}")
        r = r_min_check(pearson(np, y, ref), 0.99)
        res = {"phase": "uni_slide", "source": "patches", "patches": n,
               "shape": list(y.shape), "finite": True, "seconds": secs,
               "plain_seconds": plain_s, "launches": lc, "pearson_r_vs_plain": r}
        if n == PATCHES:  # where the slide's time goes, stage by stage
            f, res["features_s"], _ = timed(fast.extractor.features, patches)
            cf, res["kmeans_s"], _ = timed(fast.cluster, f)
            _, res["plain_kmeans_s"], _ = timed(plain.cluster, f)
            _, res["vis_folds_s"], _ = timed(fast.predict_cluster_features, cf)
            res["lloyd_steps"] = km_steps(torch, dev, f, fast)
        emit(res)

    wsi = [make_slide(torch, dev, s) for s in (1, 2)]
    for i, slide in enumerate(wsi):
        k0 = fast.io_stats["kept"]
        y, secs, lc = timed(fast.predict_wsi, slide)
        add(lc)
        kept = fast.io_stats["kept"] - k0
        k0 = plain.io_stats["kept"]
        ref, plain_s, _ = timed(plain.predict_wsi, slide)
        kept_plain = plain.io_stats["kept"] - k0
        if y.shape != (1, GENES) or not np.isfinite(y).all() or lc["lloyd_stats"] == 0:
            raise AssertionError(f"uni WSI slide {i}: {y.shape}, launches {lc}")
        if kept != kept_plain or resnet_kept[i] not in (None, kept):
            raise AssertionError(f"uni WSI slide {i}: kept {kept} / plain {kept_plain}, the "
                                 f"ResNet predictor {resnet_kept[i]}")
        emit({"phase": "uni_slide", "source": "wsi", "slide": i, "kept": kept,
              "kept_resnet": resnet_kept[i], "shape": list(y.shape), "finite": True,
              "seconds": secs, "plain_seconds": plain_s, "launches": lc,
              "pearson_r_vs_plain": r_min_check(pearson(np, y, ref), 0.99)})
    del fast, plain, ext
    torch.cuda.empty_cache()

    # the serve CLI: the five folds as a CV directory, the slides as files
    genes = [f"GENE{i:05d}" for i in range(GENES)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_uni_")
    try:
        exp = os.path.join(tmp, "exp")
        for i, (cfg, fp) in enumerate(folds):
            checkpoint.save_torch_state_dict(convert.vis_to_torch(cfg, fp),
                                             os.path.join(exp, f"model_best_{i}.pt"))
        with open(os.path.join(exp, "test_results.pkl"), "wb") as f:
            pickle.dump({"genes": genes}, f)
        from sequoia_tpu_torch import native

        try:
            import PIL  # noqa: F401
            writer = "native" if native.available() else "pillow"
        except ImportError:
            writer = "native" if native.available() else None
        if writer is None:
            raise AssertionError("uni_serve_cli: neither the native writer nor Pillow")
        paths = [os.path.join(tmp, f"slide{i}.tiff") for i in range(len(wsi))]
        for slide, path in zip(wsi, paths):
            write_slide_file(slide, path, writer)
        args = ["--wsi", *paths, "--checkpoints", exp, "--feat_type", "uni", "--weights",
                "random", "--batch_size", str(FEAT_BATCH), "--num_clusters", str(K),
                "--patch_size", str(PATCH), "--compute_dtype", "bfloat16", "--device", dev.type]
        runs = {}
        for i, (name, extra) in enumerate((("warm_up", []), ("kernels", []),
                                           ("plain", ["--kernels", "off"]))):
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            out = cli.main([*args, *extra, "--out", os.path.join(tmp, f"{name}{i}.csv")])
            torch.cuda.synchronize()
            runs[name] = {**out, "main_seconds": time.perf_counter() - t0,
                          "csv": read_csv(out["out"]),
                          "launches": {k: _build.LAUNCHES[k] - before[k] for k in before}}
        for name, run in runs.items():
            header, rows, vals = run["csv"]
            if header != ["wsi_file_name", *genes] or vals.shape != (len(paths), GENES) \
                    or not np.isfinite(vals).all():
                raise AssertionError(f"uni_serve_cli: {name} CSV {vals.shape}")
        if runs["kernels"]["launches"]["lloyd_stats"] == 0:
            raise AssertionError("uni_serve_cli: the kernel run launched no K5")
        add(runs["kernels"]["launches"])
        r = min(pearson(np, runs["kernels"]["csv"][2][i], runs["plain"]["csv"][2][i])
                for i in range(len(paths)))
        emit({"phase": "uni_serve_cli", "slide_files_by": writer, "slides": len(paths),
              "csv_shape": list(runs["kernels"]["csv"][2].shape),
              "seconds_per_slide": runs["kernels"]["serve_seconds"] / len(paths),
              "plain_seconds_per_slide": runs["plain"]["serve_seconds"] / len(paths),
              "warm_up_seconds_per_slide": runs["warm_up"]["serve_seconds"] / len(paths),
              "main_seconds": {k: v["main_seconds"] for k, v in runs.items()},
              "launches": runs["kernels"]["launches"],
              "pearson_r_min_vs_plain": r_min_check(r, 0.99)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# phase 8: the training plane (ViS and ViT; no TPU kernel is on this path)
# ---------------------------------------------------------------------------

def train_model(torch, dev, kind: str, compute_dtype=None, depth: int = 6, dim=None,
                genes=None, seed: int = 300):
    """(cfg, params, apply_fn) of ``cv.build_model`` (16 heads x 64, 100
    tokens; D and GENES unless given) from a seed, on ``dev``."""
    from sequoia_tpu_torch.train import cv

    cfg, params, apply_fn, _, _ = cv.build_model(
        kind, genes or GENES, dim or D, torch.Generator(device=dev).manual_seed(seed),
        depth=depth,
        num_clusters=K, compute_dtype=compute_dtype)
    return cfg, params, apply_fn


def train_step_flops(kind: str, cfg, batch: int) -> float:
    """Multiply-adds x 2 of one train step: the forward (per token and block
    the GEMMs, for the ViT also both attention products; then the gene
    head), and twice the forward for the backward."""
    n = cfg.num_clusters
    if kind == "vis":
        d, h = cfg.input_dim, cfg.nheads
        per_token = (2 * d * h * (cfg.dim_f + cfg.dim_s) + 2 * h * (cfg.dim_f + cfg.dim_s)
                     * cfg.dim_c + 2 * cfg.proj_in * d + 4 * d * d)
    else:
        d, inner = cfg.dim, cfg.inner_dim
        per_token = 2 * d * 3 * inner + 4 * n * inner + 2 * inner * d + 4 * d * cfg.mlp_dim
    return 3.0 * batch * (n * cfg.depth * per_token + 2 * d * cfg.num_outputs)


def op_kind(name: str) -> str:
    """A device kernel's class in a train-step trace."""
    low = name.lower()
    if any(s in low for s in ("gemm", "nvjet", "cutlass", "xmma", "sm90_", "sm80_", "cublas")):
        return "gemm"
    if any(s in low for s in ("multi_tensor", "foreach", "adam")):
        return "optimizer"
    return "elementwise"


def batch_on(torch, dev, gen, dim: int, genes: int, pad: int = 0, dtype=None):
    """One (features, targets, valid) batch of TRAIN_BATCH slides, the last
    ``pad`` rows padding."""
    x = torch.randn((TRAIN_BATCH, K, dim), generator=gen, device=gen.device)
    y = torch.randn((TRAIN_BATCH, genes), generator=gen, device=gen.device)
    valid = torch.arange(TRAIN_BATCH, device=gen.device) < TRAIN_BATCH - pad
    return x.to(dev, dtype or torch.float32), y.to(dev), valid.to(dev)


def train_parity(torch, dev) -> dict:
    """Three AdamW steps of the ViS on the card against the same three steps
    on the CPU: the same weights and batches, f32, depth 2, D = 256, G =
    1,000; per leaf max |card - cpu| / max |cpu|, raising past PARITY_TOL."""
    from sequoia_tpu_torch.train import loop

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    _, params, apply_fn = train_model(torch, cpu, "vis", depth=PARITY_DEPTH, dim=PARITY_DIM,
                                      genes=PARITY_GENES, seed=320)
    g = torch.Generator().manual_seed(321)
    batches = [batch_on(torch, cpu, g, PARITY_DIM, PARITY_GENES, pad=5 * (i == 2))
               for i in range(3)]
    runs = {}
    for name, where in (("host", cpu), ("card", dev)):
        p = loop.tree_map(lambda t: t.to(where, copy=True).requires_grad_(True), params)
        step, _ = loop.make_step_fns(apply_fn, loop.make_adamw(p, lr=TRAIN_LR))
        metrics = [step(p, *(t.to(where) for t in b)) for b in batches]
        runs[name] = (p, [{k: float(v) for k, v in m.items()} for m in metrics])
    (card, card_m), (host, host_m) = runs["card"], runs["host"]
    rel = {}
    for path, (a, b) in zip(leaf_paths(params), zip(loop.tree_leaves(card),
                                                     loop.tree_leaves(host))):
        b = b.detach()
        rel[path] = float((a.detach().cpu() - b).abs().max() / b.abs().max().clamp(min=1e-30))
    moved = float((host["head_w"].detach() - params["head_w"]).abs().max())
    worst = max(rel, key=rel.get)
    m_rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                for a, b in zip(card_m, host_m) for k in b)
    if rel[worst] > PARITY_TOL or m_rel > PARITY_TOL:
        raise AssertionError(f"train_parity: {worst} {rel[worst]:.3g}, metrics {m_rel:.3g} "
                             f"> {PARITY_TOL:g}")
    return {"steps": len(batches), "depth": PARITY_DEPTH, "dim": PARITY_DIM,
            "genes": PARITY_GENES, "optimizer": "torch.optim.AdamW foreach",
            "max_rel_by_leaf": rel, "max_rel": rel[worst], "worst_leaf": worst,
            "metrics_max_rel": m_rel, "head_w_moved": moved, "tol": PARITY_TOL,
            "card_metrics": card_m, "seconds": time.perf_counter() - t0}


def leaf_paths(tree, prefix: str = "") -> list:
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in leaf_paths(v, f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def time_train_step(torch, dev, kind: str, compute_dtype=None, moment_dtype=None,
                    trace: bool = False) -> dict:
    """ms per full-width train step (CUDA events over TRAIN_STEPS steps after
    warm-up) against its bound, the peak device memory, and optionally a
    torch.profiler trace of one step by op class."""
    from sequoia_tpu_torch.train import loop

    t0 = time.perf_counter()
    cfg, params, apply_fn = train_model(torch, dev, kind, compute_dtype)
    params = loop.tree_map(lambda t: t.requires_grad_(True), params)
    opt = loop.make_adamw(params, lr=TRAIN_LR, moment_dtype=moment_dtype)
    step, _ = loop.make_step_fns(apply_fn, opt)
    dim = cfg.input_dim if kind == "vis" else cfg.dim
    x, y, valid = batch_on(torch, dev, torch.Generator(device=dev).manual_seed(310), dim,
                           GENES, dtype=torch.bfloat16 if compute_dtype else None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    last = {}

    def run():
        last.update(step(params, x, y, valid))

    for _ in range(2):
        run()
    ms = time_ms(torch, run, TRAIN_STEPS)
    if not all(bool(torch.isfinite(v)) for v in last.values()):
        raise AssertionError(f"train_step {kind}: metrics not finite {last}")
    n_params = sum(t.numel() for t in loop.tree_leaves(params))
    flops = train_step_flops(kind, cfg, TRAIN_BATCH)
    moment = "bfloat16" if moment_dtype else "float32"
    moved = n_params * ADAMW_BYTES[moment] + nbytes(x, y, valid)
    bnd, by = bound_ms(moved, flops, "bfloat16" if compute_dtype else "float32")
    res = {"model": kind, "compute_dtype": compute_dtype or "float32", "moment_dtype": moment,
           "optimizer": type(opt).__name__, "batch": TRAIN_BATCH, "params": n_params,
           "ms": ms, "steps_timed": TRAIN_STEPS, "tflop_per_step": flops / 1e12,
           "bound_ms": bnd, "bound_by": by, "bound_share": bnd / ms,
           "tflops": flops / ms / 1e9, "adamw_gb": n_params * ADAMW_BYTES[moment] / 1e9,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "last_loss": float(last["loss"])}
    if trace:
        res["profile"] = profile_batch(torch, run, iters=1, kind=op_kind)
    res["seconds"] = time.perf_counter() - t0
    del opt, params
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def feature_store(store):
    """For the length of the block, ``FeatureDataset.load_features`` and
    ``filter_no_features`` read ``store`` ({h5 path: (tokens, D) array})
    instead of .h5 files; None leaves them as they are."""
    from sequoia_tpu_torch.data import dataset as tds

    if store is None:
        yield
        return
    load, filt = tds.FeatureDataset.load_features, tds.filter_no_features

    def from_memory(self, idx):
        return store.get(self.h5_path(idx))

    def filter_in_memory(df, feature_path, feature_name="cluster_features", verbose=True):
        keep = [tds.slide_h5_path(feature_path, r.get("tcga_project", ""),
                                  r["wsi_file_name"]) in store for _, r in df.iterrows()]
        return df[keep].reset_index(drop=True)

    tds.FeatureDataset.load_features, tds.filter_no_features = from_memory, filter_in_memory
    try:
        yield
    finally:
        tds.FeatureDataset.load_features, tds.filter_no_features = load, filt


def write_cohort(np, root: str):
    """CV_SLIDES slides of CV_PATIENTS patients: (100, 2048) cluster features
    and GENES targets from a seed.  Writes ``ref.csv`` (all genes) and
    ``ft.csv`` (the first FT_GENES) under ``root``; the features go to .h5
    files where h5py imports, else into a dict for :func:`feature_store`.
    Returns (features root, store or None, source)."""
    import pandas as pd
    from sequoia_tpu_torch.data import dataset as tds

    rng = np.random.default_rng(330)
    feats = rng.standard_normal((CV_SLIDES, K, D), dtype=np.float32)
    rna = rng.standard_normal((CV_SLIDES, GENES), dtype=np.float32)
    meta = pd.DataFrame({"wsi_file_name": [f"TCGA-SYN-{i:03d}.svs" for i in range(CV_SLIDES)],
                         "patient_id": [f"P{i % CV_PATIENTS:02d}" for i in range(CV_SLIDES)],
                         "tcga_project": "TCGA-SYN"})
    genes = pd.DataFrame(rna, columns=[f"rna_GENE{i:05d}" for i in range(GENES)])
    pd.concat([meta, genes], axis=1).to_csv(os.path.join(root, "ref.csv"), index=False,
                                            float_format="%.5f")
    pd.concat([meta, genes.iloc[:, :FT_GENES]], axis=1).to_csv(
        os.path.join(root, "ft.csv"), index=False, float_format="%.5f")
    feat_root = os.path.join(root, "features")
    paths = [tds.slide_h5_path(feat_root, "TCGA-SYN", w) for w in meta["wsi_file_name"]]
    try:
        import h5py
    except ImportError:
        return feat_root, dict(zip(paths, feats)), "memory (h5py does not import)"
    for path, f in zip(paths, feats):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with h5py.File(path, "w") as h:
            h.create_dataset("cluster_features", data=f)
    return feat_root, None, "h5 files (h5py imports)"


def counting_step_fns(real_fns, rec: dict):
    """``loop.make_step_fns`` wrapped so that each train step adds one to
    ``rec["steps"]``."""
    def make(apply_fn, opt):
        step, ev = real_fns(apply_fn, opt)

        def counted(*a):
            rec["steps"] += 1
            return step(*a)
        return counted, ev
    return make


def timed_calls(torch, rec: dict, key: str, fn):
    """``fn`` wrapped to add its seconds (ending in a synchronize) to
    ``rec[key]``."""
    def run(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            torch.cuda.synchronize()
            rec[key] = rec.get(key, 0.0) + time.perf_counter() - t0
    return run


def train_cv(torch, dev, root: str, feat_root: str) -> dict:
    """``cli.main`` 5-fold CV of the ViS at full width, 2 epochs: seconds per
    fold and epoch, train steps per second, and the outputs checked."""
    import pickle
    from unittest import mock

    import numpy as np
    from sequoia_tpu_torch.cli import main as cli_main
    from sequoia_tpu_torch.train import checkpoint, loop

    rec = {"train": [], "steps": 0, "saves": []}
    real_train, real_fns, real_save = (loop.train, loop.make_step_fns,
                                       checkpoint.save_torch_state_dict)

    def timed_train(*a, **kw):
        t0 = time.perf_counter()
        res = real_train(*a, **kw)
        torch.cuda.synchronize()
        rec["train"].append((t0, time.perf_counter() - t0, len(res.history)))
        return res

    def timed_save(sd, path):
        t0 = time.perf_counter()
        real_save(sd, path)
        rec["saves"].append((time.perf_counter() - t0, os.path.getsize(path)))

    args = ["--ref_file", os.path.join(root, "ref.csv"), "--feature_path", feat_root,
            "--model_type", "vis", "--train", "--k", "5", "--num_epochs", "2",
            "--filter_no_features", "0", "--save_dir", os.path.join(root, "exp"),
            "--exp_name", "cv", "--batch_size", str(TRAIN_BATCH), "--lr", str(TRAIN_LR)]
    with mock.patch.object(loop, "train", timed_train), \
            mock.patch.object(loop, "make_step_fns", counting_step_fns(real_fns, rec)), \
            mock.patch.object(checkpoint, "save_torch_state_dict", timed_save), \
            mock.patch.object(loop, "evaluate", timed_calls(torch, rec, "evaluate_s",
                                                            loop.evaluate)):
        t0 = time.perf_counter()
        out = cli_main.main(args)
        torch.cuda.synchronize()
        end = time.perf_counter()
    exp = os.path.join(root, "exp", "TCGA", "cv")
    with open(os.path.join(exp, "test_results.pkl"), "rb") as f:
        on_disk = pickle.load(f)
    want = {f"split_{i}" for i in range(5)} | {"genes"}
    if set(on_disk) != want or len(on_disk["genes"]) != GENES:
        raise AssertionError(f"train_cv: test_results.pkl keys {sorted(on_disk)[:8]}")
    n_test = 0
    for i in range(5):
        s = on_disk[f"split_{i}"]
        n = len(s["wsi_file_name"])
        n_test += n
        for key in ("real", "preds", "random"):
            if s[key].shape != (n, GENES) or not np.isfinite(s[key]).all():
                raise AssertionError(f"train_cv: split_{i} {key} {s[key].shape}")
        np.testing.assert_array_equal(s["preds"], out[f"split_{i}"]["preds"])
        sd = checkpoint.load_torch_checkpoint(os.path.join(exp, f"model_best_{i}.pt"))
        if sd["linear_head.1.weight"].shape != (GENES, D) or not all(
                np.isfinite(v).all() for v in sd.values()):
            raise AssertionError(f"train_cv: model_best_{i}.pt does not load back whole")
    if n_test != CV_SLIDES:
        raise AssertionError(f"train_cv: {n_test} test rows over the folds, not {CV_SLIDES}")
    starts = [t for t, _, _ in rec["train"]] + [end]
    epochs = sum(e for _, _, e in rec["train"])
    train_s = sum(s for _, s, _ in rec["train"])
    return {"folds": len(rec["train"]), "epochs": epochs, "seconds": end - t0,
            "seconds_per_fold": [b - a for a, b in zip(starts, starts[1:])],
            "train_seconds_per_fold": [s for _, s, _ in rec["train"]],
            "seconds_per_epoch": train_s / epochs, "train_steps": rec["steps"],
            "train_steps_per_s": rec["steps"] / train_s,
            "checkpoint_writes": len(rec["saves"]),
            "checkpoint_write_s": sum(s for s, _ in rec["saves"]),
            "checkpoint_gb": sum(b for _, b in rec["saves"]) / 1e9,
            "evaluate_s": rec["evaluate_s"],
            "rest_s": end - t0 - train_s - rec["evaluate_s"],
            "test_rows": n_test, "preds_finite": True, "folds_load_back": True}


def train_resume(torch, dev, root: str, feat_root: str) -> dict:
    """``cli.main --resume --moment_dtype bfloat16`` twice (k = 2, one
    epoch): the second run trains no step, and its optimizers come back with
    bf16 moments bit-equal to the saved ones."""
    from unittest import mock

    from sequoia_tpu_torch.cli import main as cli_main
    from sequoia_tpu_torch.train import checkpoint, loop

    args = ["--ref_file", os.path.join(root, "ref.csv"), "--feature_path", feat_root,
            "--model_type", "vis", "--train", "--k", "2", "--num_epochs", "1", "--resume",
            "--moment_dtype", "bfloat16", "--filter_no_features", "0",
            "--save_dir", os.path.join(root, "exp"), "--exp_name", "resume",
            "--batch_size", str(TRAIN_BATCH)]
    real_make, real_fns = loop.make_adamw, loop.make_step_fns
    runs = []
    for _ in range(2):
        rec = {"opts": [], "steps": 0}

        def capture(*a, _rec=rec, **kw):
            opt = real_make(*a, **kw)
            _rec["opts"].append(opt)
            return opt

        with mock.patch.object(loop, "make_adamw", capture), \
                mock.patch.object(loop, "make_step_fns", counting_step_fns(real_fns, rec)), \
                mock.patch.object(checkpoint, "save_train_state", timed_calls(
                    torch, rec, "state_save_s", checkpoint.save_train_state)), \
                mock.patch.object(checkpoint, "load_train_state", timed_calls(
                    torch, rec, "state_load_s", checkpoint.load_train_state)):
            t0 = time.perf_counter()
            cli_main.main(args)
            torch.cuda.synchronize()
            rec["seconds"] = time.perf_counter() - t0
        runs.append(rec)
    exp = os.path.join(root, "exp", "TCGA", "resume")
    if runs[0]["steps"] == 0 or runs[1]["steps"] != 0:
        raise AssertionError(f"train_resume: steps {runs[0]['steps']} then {runs[1]['steps']}")
    compared = 0
    for i, opt in enumerate(runs[1]["opts"]):
        _, saved, meta = checkpoint.load_train_state(os.path.join(exp, f"train_state_{i}.npz"))
        if meta["epoch"] != 0:
            raise AssertionError(f"train_resume: fold {i} state at epoch {meta['epoch']}")
        live = opt.state_dict()["state"]
        for j, st in saved["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                got = live[j][k]
                if got.dtype != torch.bfloat16 or st[k].dtype != torch.bfloat16 or \
                        not torch.equal(got.cpu(), st[k]):
                    raise AssertionError(f"train_resume: fold {i} state {j} {k} "
                                         f"{got.dtype} not bit-equal to the saved bf16")
                compared += 1
    state_gb = os.path.getsize(os.path.join(exp, "train_state_0.npz")) / 1e9
    del runs[0]["opts"], runs[1]["opts"]
    torch.cuda.empty_cache()
    return {"first_run_s": runs[0]["seconds"], "first_run_steps": runs[0]["steps"],
            "first_run_state_save_s": runs[0].get("state_save_s", 0.0),
            "second_run_s": runs[1]["seconds"], "second_run_steps": 0,
            "second_run_state_load_s": runs[1].get("state_load_s", 0.0),
            "moments_compared": compared, "moments_bf16_bit_equal": True,
            "train_state_gb": state_gb}


def train_gtex(torch, dev, root: str, feat_root: str) -> dict:
    """``cli.pretrain_gtex --quick 1`` at GENES, then ``cli.main --checkpoint
    <its model_best.pt> --change_num_genes GENES`` on the FT_GENES cohort:
    the head swapped on the card, the blocks carried over, finite preds."""
    import numpy as np
    from sequoia_tpu_torch.cli import main as cli_main
    from sequoia_tpu_torch.cli import pretrain_gtex
    from sequoia_tpu_torch.train import checkpoint

    t0 = time.perf_counter()
    pre = pretrain_gtex.main(["--path_csv", os.path.join(root, "ref.csv"), "--feature_path",
                              feat_root, "--model", "vis", "--quick", "1", "--save_dir",
                              os.path.join(root, "pre"), "--exp_name", "gtex",
                              "--batch_size", str(TRAIN_BATCH)])
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    sd_pre = checkpoint.load_torch_checkpoint(pre)
    if sd_pre["linear_head.1.weight"].shape != (GENES, D):
        raise AssertionError(f"train_gtex: {pre} head {sd_pre['linear_head.1.weight'].shape}")
    t0 = time.perf_counter()
    out = cli_main.main(["--ref_file", os.path.join(root, "ft.csv"), "--feature_path",
                         feat_root, "--model_type", "vis", "--train", "--k", "2",
                         "--num_epochs", "1", "--filter_no_features", "0", "--checkpoint",
                         pre, "--change_num_genes", str(GENES), "--save_dir",
                         os.path.join(root, "exp"), "--exp_name", "ft",
                         "--batch_size", str(TRAIN_BATCH)])
    torch.cuda.synchronize()
    ft_s = time.perf_counter() - t0
    exp = os.path.join(root, "exp", "TCGA", "ft")
    sd = checkpoint.load_torch_checkpoint(os.path.join(exp, "model_best_0.pt"))
    preds = [out[f"split_{i}"]["preds"] for i in range(2)]
    if sd["linear_head.1.weight"].shape != (FT_GENES, D) or any(
            p.shape[1] != FT_GENES or not np.isfinite(p).all() for p in preds):
        raise AssertionError(f"train_gtex: fine-tuned head {sd['linear_head.1.weight'].shape}")
    drift = float(np.abs(sd["pos_emb1D"] - sd_pre["pos_emb1D"]).max())
    if drift > 0.05:  # one epoch of AdamW at lr 1e-3; a fresh draw is N(0, 1)
        raise AssertionError(f"train_gtex: the blocks did not carry over ({drift})")
    return {"pretrain_s": pre_s, "pretrain_head": list(sd_pre["linear_head.1.weight"].shape),
            "finetune_s": ft_s, "finetune_head": list(sd["linear_head.1.weight"].shape),
            "finetune_preds": [list(p.shape) for p in preds], "preds_finite": True,
            "pos_emb_drift_max": drift}


def train_path(torch, dev, keep: dict | None = None) -> dict:
    """Phase 8; returns the kernels' launch counts over it (none of K1-K5 is
    on the training path).  ``keep`` (a dict) receives the bytes of the CV's
    ``test_results.pkl`` under "test_results" (phase 10 evaluates them)."""
    import shutil
    import tempfile

    import numpy as np
    from sequoia_tpu_torch import _build

    before = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    emit({"phase": "train_parity", **train_parity(torch, dev)})
    torch.cuda.empty_cache()
    for kind, cdt, mdt in (("vis", None, None), ("vis", "bfloat16", None),
                           ("vis", "bfloat16", "bfloat16"), ("vit", None, None)):
        emit({"phase": "train_step", **time_train_step(torch, dev, kind, cdt, mdt,
                                                        trace=kind == "vis" and mdt is None)})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        t0 = time.perf_counter()
        feat_root, store, source = write_cohort(np, tmp)
        cohort = {"slides": CV_SLIDES, "patients": CV_PATIENTS, "tokens": K, "dim": D,
                  "genes": GENES, "features_from": source,
                  "write_s": time.perf_counter() - t0}
        with feature_store(store):
            emit({"phase": "train_cv", "cohort": cohort, **train_cv(torch, dev, tmp, feat_root)})
            if keep is not None:
                with open(os.path.join(tmp, "exp", "TCGA", "cv", "test_results.pkl"), "rb") as f:
                    keep["test_results"] = f.read()
            shutil.rmtree(os.path.join(tmp, "exp"))
            emit({"phase": "train_resume", **train_resume(torch, dev, tmp, feat_root)})
            shutil.rmtree(os.path.join(tmp, "exp"))
            emit({"phase": "train_gtex", **train_gtex(torch, dev, tmp, feat_root)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: _build.LAUNCHES[k] - before[k] for k in before}
    emit({"phase": "train_launches", **launches, "phase_seconds": time.perf_counter() - t0})
    return launches


# ---------------------------------------------------------------------------
# phase 9: HE2RNA trained and served, the ViT served, spatial maps, and
# independent-cohort prediction
# ---------------------------------------------------------------------------

# HE2RNA at the reference's width: D -> 256 -> 256 -> GENES per tile over K
# tokens, batch 16, Dropout(0.5); he2rna_parity small (the CPU side stays
# quick) with dropout 0 and one k, held to train_parity's 5e-4
HE_LAYERS, HE_PARITY_DIM, HE_PARITY_GENES, HE_PARITY_K = (256, 256), 256, 1000, 10
# bytes a parameter that the Adam step must move: p, m, v read and written, g read
ADAM_BYTES = 28
# the ViT folds served: dim and MLP 2048 (full width), depth cut from 6 to 2
# (every CLI run loads the five folds from disk)
SERVE_VIT_DEPTH = 2
# the spatial phase: the CLI's stride, and the stride of the host float64
# against device f32 check at every gene (the host's row adds cost seconds)
SPATIAL_STRIDE, SPATIAL_HOST_STRIDE = 1, 3
SPATIAL_PROJECT, SPATIAL_WSI, STUDY = "TCGA-SYN", "TCGA-SYN-0001.svs", "syn"


def he2rna_op_kind(name: str) -> str:
    """A device kernel's class in an HE2RNA train-step trace."""
    low = name.lower()
    if any(s in low for s in ("topk", "sort", "radix", "bitonic")):
        return "topk"
    if "scatter" in low:
        return "scatter"
    return op_kind(name)


def he2rna_batch(torch, gen, dim: int, genes: int):
    """One batch of TRAIN_BATCH slides: non-negative tile features (ResNet
    features are post-ReLU) with 0, 10, 20 or 30 zero-padded tail tiles,
    targets, and every row valid."""
    dev = gen.device
    x = torch.randn((TRAIN_BATCH, K, dim), generator=gen, device=dev).abs()
    keep = K - (torch.arange(TRAIN_BATCH, device=dev) % 4) * 10
    x = x * (torch.arange(K, device=dev)[None, :] < keep[:, None])[..., None]
    y = torch.randn((TRAIN_BATCH, genes), generator=gen, device=dev)
    return x, y, torch.ones(TRAIN_BATCH, dtype=torch.bool, device=dev)


def he2rna_parity(torch, dev) -> dict:
    """Three Adam steps of a small HE2RNA (dropout 0, one k) on the card
    against the same steps on the CPU: per leaf max |card - cpu| / max |cpu|,
    raising past PARITY_TOL."""
    from sequoia_tpu_torch.models import he2rna
    from sequoia_tpu_torch.train import he2rna_fit, loop

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    cfg = he2rna.HE2RNAConfig(input_dim=HE_PARITY_DIM, output_dim=HE_PARITY_GENES,
                              layers=HE_LAYERS, ks=(HE_PARITY_K,), dropout=0.0)
    params = he2rna.init(cfg, torch.Generator().manual_seed(340))
    g = torch.Generator().manual_seed(341)
    batches = [he2rna_batch(torch, g, HE_PARITY_DIM, HE_PARITY_GENES) for _ in range(3)]
    runs = {}
    for name, where in (("host", cpu), ("card", dev)):
        p = loop.tree_map(lambda t: t.to(where, copy=True).requires_grad_(True), params)
        step, _ = he2rna_fit.make_he2rna_step_fns(cfg, loop.make_adam(p, TRAIN_LR),
                                                  k_gen=torch.Generator().manual_seed(0))
        runs[name] = (p, [float(step(p, *(t.to(where) for t in b))) for b in batches])
    (card, card_l), (host, host_l) = runs["card"], runs["host"]
    rel = {}
    for key in ("w", "b"):
        for i, (a, b) in enumerate(zip(card[key], host[key])):
            b = b.detach()
            rel[f"{key}{i}"] = float((a.detach().cpu() - b).abs().max()
                                     / b.abs().max().clamp(min=1e-30))
    worst = max(rel, key=rel.get)
    l_rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(card_l, host_l))
    if rel[worst] > PARITY_TOL or l_rel > PARITY_TOL:
        raise AssertionError(f"he2rna_parity: {worst} {rel[worst]:.3g}, loss {l_rel:.3g} "
                             f"> {PARITY_TOL:g}")
    moved = float((host["w"][-1].detach() - params["w"][-1]).abs().max())
    return {"steps": len(batches), "dim": HE_PARITY_DIM, "layers": list(HE_LAYERS),
            "genes": HE_PARITY_GENES, "tokens": K, "k": HE_PARITY_K, "dropout": 0.0,
            "optimizer": "torch.optim.Adam foreach", "max_rel_by_leaf": rel,
            "max_rel": rel[worst], "worst_leaf": worst, "loss_max_rel": l_rel,
            "head_w_moved": moved, "tol": PARITY_TOL, "card_losses": card_l,
            "seconds": time.perf_counter() - t0}


def he2rna_step(torch, dev) -> dict:
    """ms per full-width HE2RNA train step (f32, batch 16, 100 tokens,
    Dropout(0.5), k drawn per step) against its bound, the peak device
    memory, a torch.profiler trace of three steps by op class, and the eval
    forward's k sweep."""
    from sequoia_tpu_torch.models import he2rna
    from sequoia_tpu_torch.train import he2rna_fit, loop

    t0 = time.perf_counter()
    cfg = he2rna.HE2RNAConfig(input_dim=D, output_dim=GENES, layers=HE_LAYERS,
                              ks=he2rna.ks_for_tokens(K))
    params = he2rna.init(cfg, torch.Generator(device=dev).manual_seed(342))
    params = loop.tree_map(lambda t: t.requires_grad_(True), params)
    opt = loop.make_adam(params, TRAIN_LR)
    step, _ = he2rna_fit.make_he2rna_step_fns(
        cfg, opt, gen=torch.Generator(device=dev).manual_seed(343),
        k_gen=torch.Generator().manual_seed(344))
    x, y, valid = he2rna_batch(torch, torch.Generator(device=dev).manual_seed(345), D, GENES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    last = {}

    def run():
        last["loss"] = step(params, x, y, valid)

    for _ in range(2):
        run()
    ms = time_ms(torch, run, TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not bool(torch.isfinite(last["loss"])):
        raise AssertionError(f"he2rna_step: loss {last['loss']}")
    if peak > 13.0:
        raise AssertionError(f"he2rna_step: peak memory {peak:.2f} GB (a (B, G, k, T) "
                             "one-hot would take 13.3 GB)")
    n_params = sum(t.numel() for t in loop.tree_leaves(params))
    rows = TRAIN_BATCH * K
    fwd = 2.0 * rows * (D * HE_LAYERS[0] + HE_LAYERS[0] * HE_LAYERS[1] + HE_LAYERS[1] * GENES)
    flops = 3 * fwd - 2.0 * rows * D * HE_LAYERS[0]  # no gradient of the input tiles
    bnd, by = bound_ms(n_params * ADAM_BYTES + nbytes(x, y, valid), flops, "float32")
    res = {"model": "he2rna", "dtype": "float32", "batch": TRAIN_BATCH, "tokens": K,
           "dim": D, "layers": list(HE_LAYERS), "genes": GENES, "ks": list(cfg.ks),
           "dropout": cfg.dropout, "optimizer": type(opt).__name__, "params": n_params,
           "ms": ms, "steps_timed": TRAIN_STEPS, "gflop_per_step": flops / 1e9,
           "bound_ms": bnd, "bound_by": by, "bound_share": bnd / ms,
           "tflops": flops / ms / 1e9, "scores_gb": rows * GENES * 4 / 1e9,
           "max_memory_allocated_gb": peak, "last_loss": float(last["loss"]),
           "profile": profile_batch(torch, run, iters=3, kind=he2rna_op_kind)}

    def eval_fwd():
        with torch.no_grad():
            last["pred"] = he2rna.apply(cfg, params, x)

    res["eval_forward_ms"] = time_ms(torch, eval_fwd, TRAIN_STEPS)
    res["eval_forward_bound_ms"] = bound_ms(
        n_params * 4 + nbytes(x) + TRAIN_BATCH * GENES * 4, fwd, "float32")[0]
    if not bool(torch.isfinite(last["pred"]).all()):
        raise AssertionError("he2rna_step: eval forward not finite")
    res["seconds"] = time.perf_counter() - t0
    del opt, params, last
    torch.cuda.empty_cache()
    return res


def he2rna_cv(torch, dev, root: str, feat_root: str) -> dict:
    """``cli.he2rna`` 5-fold CV for 2 epochs with ``--hf_export`` on the
    phase 8 cohort, its outputs checked; then ``cli.pretrain_gtex --model
    he2rna --quick 1`` and a fine-tune through ``cli.he2rna --checkpoint
    --change_num_genes`` on FT_GENES genes."""
    import pickle
    from unittest import mock

    import numpy as np
    from sequoia_tpu_torch.cli import he2rna as cli_he
    from sequoia_tpu_torch.cli import pretrain_gtex
    from sequoia_tpu_torch.train import checkpoint, cv, he2rna_fit

    fits = []
    real_fit = he2rna_fit.fit

    def timed_fit(*a, **kw):
        t0 = time.perf_counter()
        out = real_fit(*a, **kw)
        torch.cuda.synchronize()
        fits.append(time.perf_counter() - t0)
        return out

    common = ["--feature_path", feat_root, "--batch_size", str(TRAIN_BATCH), "--device",
              dev.type, "--destfolder", os.path.join(root, "he")]
    real_cv = cv.run_he2rna_cross_validation

    def epochs(n):  # the CLI's fits run n of the reference's 200 epochs
        return mock.patch.object(cv, "run_he2rna_cross_validation",
                                 functools.partial(real_cv, max_epochs=n))

    with mock.patch.object(he2rna_fit, "fit", timed_fit), epochs(2):
        t0 = time.perf_counter()
        cli_he.main(["--path_csv", os.path.join(root, "ref.csv"), "--k", "5", "--hf_export",
                     "--exp_name", "cv", *common])
        torch.cuda.synchronize()
        cv_s = time.perf_counter() - t0
    exp = os.path.join(root, "he", "cv")
    with open(os.path.join(exp, "test_results.pkl"), "rb") as f:
        res = pickle.load(f)
    if set(res) != {f"split_{i}" for i in range(5)} | {"genes"} or len(res["genes"]) != GENES:
        raise AssertionError(f"he2rna_cv: test_results.pkl keys {sorted(res)[:8]}")
    names = []
    for i in range(5):
        s = res[f"split_{i}"]
        n = len(s["wsi_file_name"])
        names += list(s["wsi_file_name"])
        for key in ("real", "preds", "random"):
            if s[key].shape != (n, GENES) or not np.isfinite(s[key]).all():
                raise AssertionError(f"he2rna_cv: split_{i} {key} {s[key].shape}")
        if (s["preds"] < 0).any():
            raise AssertionError(f"he2rna_cv: split_{i} preds below 0 (no predict-time ReLU)")
        best = checkpoint.load_torch_checkpoint(os.path.join(exp, f"model_{i}.pt"))
        hf = checkpoint.load_hf_vis_state_dict(os.path.join(exp, f"hf_fold_{i}"))
        if best["conv2.weight"].shape != (GENES, HE_LAYERS[1], 1) or sorted(hf) != sorted(
                best) or not all(np.array_equal(hf[k], best[k]) for k in best):
            raise AssertionError(f"he2rna_cv: model_{i}.pt and hf_fold_{i} differ")
    if len(set(names)) != len(names) or len(names) != CV_SLIDES:
        raise AssertionError(f"he2rna_cv: {len(names)} test rows, {len(set(names))} slides")

    t0 = time.perf_counter()
    pre = pretrain_gtex.main(["--path_csv", os.path.join(root, "ref.csv"), "--feature_path",
                              feat_root, "--model", "he2rna", "--quick", "1", "--save_dir",
                              os.path.join(root, "pre"), "--exp_name", "he", "--batch_size",
                              str(TRAIN_BATCH), "--device", dev.type])
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    sd_pre = checkpoint.load_torch_checkpoint(pre)
    t0 = time.perf_counter()
    with epochs(1):
        out = cli_he.main(["--path_csv", os.path.join(root, "ft.csv"), "--k", "2",
                           "--checkpoint", pre, "--change_num_genes", "--exp_name", "ft",
                           *common])
    torch.cuda.synchronize()
    ft_s = time.perf_counter() - t0
    sd = checkpoint.load_torch_checkpoint(os.path.join(root, "he", "ft", "model_0.pt"))
    preds = [out[f"split_{i}"]["preds"] for i in range(2)]
    if sd_pre["conv2.weight"].shape != (GENES, HE_LAYERS[1], 1) or \
            sd["conv2.weight"].shape != (FT_GENES, HE_LAYERS[1], 1) or any(
                p.shape[1] != FT_GENES or not np.isfinite(p).all() for p in preds):
        raise AssertionError(f"he2rna_cv: fine-tuned head {sd['conv2.weight'].shape}")
    drift = float(np.abs(sd["conv0.weight"] - sd_pre["conv0.weight"]).max())
    if drift > 0.05:  # a few Adam steps at lr 1e-3; a fresh draw spans +-1/sqrt(2048)
        raise AssertionError(f"he2rna_cv: the hidden layers did not carry over ({drift})")
    return {"folds": 5, "epochs": 2, "seconds": cv_s, "fit_seconds_per_fold": fits[:5],
            "test_rows": len(names), "hf_folds_equal_model_pt": True, "preds_relu": True,
            "pretrain_s": pre_s, "pretrain_head": list(sd_pre["conv2.weight"].shape),
            "finetune_s": ft_s, "finetune_head": list(sd["conv2.weight"].shape),
            "finetune_preds": [list(p.shape) for p in preds], "conv0_drift_max": drift}


def write_fold_dirs(torch, dev, root: str, vis_folds, genes):
    """The reference's checkpoint layout under ``root`` for cli.visualize
    (``{model_type}_resnet/{STUDY}/``), also served by cli.serve: the five
    ViS folds of phase 4 (``model_best_{i}.pt``), five random ViT folds (dim
    and MLP 2048, depth SERVE_VIT_DEPTH) and five random HE2RNA folds
    (``model_{i}.pt``), each directory with ``test_results.pkl``.  Returns
    ({model_type: directory}, seconds)."""
    import pickle

    from sequoia_tpu_torch.models import convert, he2rna
    from sequoia_tpu_torch.train import checkpoint, cv

    t0 = time.perf_counter()
    dirs = {t: os.path.join(root, f"{t}_resnet", STUDY) for t in ("vis", "vit", "he2rna")}
    hcfg = he2rna.HE2RNAConfig(input_dim=D, output_dim=GENES, layers=HE_LAYERS,
                               ks=he2rna.ks_for_tokens(K))
    for i in range(FOLDS):
        checkpoint.save_torch_state_dict(convert.vis_to_torch(*vis_folds[i]),
                                         os.path.join(dirs["vis"], f"model_best_{i}.pt"))
        cfg, params, _, to_torch, _ = cv.build_model(
            "vit", GENES, D, torch.Generator(device=dev).manual_seed(350 + i),
            depth=SERVE_VIT_DEPTH, num_clusters=K)
        checkpoint.save_torch_state_dict(to_torch(cfg, params),
                                         os.path.join(dirs["vit"], f"model_best_{i}.pt"))
        hp = he2rna.init(hcfg, torch.Generator(device=dev).manual_seed(360 + i))
        checkpoint.save_torch_state_dict(convert.he2rna_to_torch(hcfg, hp),
                                         os.path.join(dirs["he2rna"], f"model_{i}.pt"))
        del params, hp
    for d in dirs.values():
        with open(os.path.join(d, "test_results.pkl"), "wb") as f:
            pickle.dump({"genes": genes}, f)
    return dirs, time.perf_counter() - t0


def post_once(np, pred, genes, paths, want) -> dict:
    """One POST of every slide to ``http_serve`` over ``pred`` on a loopback
    port, the answer held against the CLI's rows (``want``: path -> row)."""
    import threading
    import urllib.request

    from sequoia_tpu_torch import http_serve

    svc = http_serve.PredictorService(pred, genes)
    srv = http_serve.make_server(svc, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        req = urllib.request.Request(
            "http://127.0.0.1:%d/predict" % srv.server_address[1],
            data=json.dumps({"wsi": paths}).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            code, out = r.status, json.loads(r.read())
        post_s = time.perf_counter() - t0
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
    if code != 200 or out["failed"] or sorted(out["predictions"]) != sorted(paths):
        raise AssertionError(f"http: POST gave {code}, failed {out['failed']}")
    r = min(pearson(np, [out["predictions"][p][g] for g in genes], want[p]) for p in paths)
    return {"code": code, "slides": len(paths), "seconds": post_s,
            "pearson_r_min_vs_cli": r_min_check(r, 0.99999)}


def serve_models(torch, dev, root: str, dirs: dict, paths: list, genes, launches) -> dict:
    """``cli.serve.main --model_type vit`` and ``he2rna`` on the slide files
    with ``build_predictor``'s kernel set (K4, K5; K1 is a ViS kernel), with
    ``--kernels off`` and with a 50-gene panel, then one HTTP POST per type.
    Adds the kernel runs' launches to ``launches``."""
    import numpy as np
    from sequoia_tpu_torch import _build
    from sequoia_tpu_torch.cli import serve as cli

    panel = genes[::GENES // PANEL][:PANEL]
    names = [os.path.basename(p) for p in paths]
    out = {}
    for t in ("vit", "he2rna"):
        args = ["--wsi", *paths, "--checkpoints", dirs[t], "--model_type", t, "--weights",
                "random", "--batch_size", str(FEAT_BATCH), "--num_clusters", str(K),
                "--patch_size", str(PATCH), "--compute_dtype", "bfloat16", "--device", dev.type]
        runs = {}
        for name, extra in (("kernels", []), ("plain", ["--kernels", "off"]),
                            ("panel", ["--panel", ",".join(panel)])):
            _build.reset_launches()
            t0 = time.perf_counter()
            res = cli.main([*args, *extra, "--out", os.path.join(root, f"{t}_{name}.csv")])
            torch.cuda.synchronize()
            if name != "plain":
                for k, v in _build.LAUNCHES.items():
                    launches[k] += v
            header, rows, vals = read_csv(res["out"])
            want = panel if name == "panel" else genes
            if header != ["wsi_file_name", *want] or rows != names or \
                    vals.shape != (len(paths), len(want)) or not np.isfinite(vals).all() or \
                    (t == "he2rna" and (vals < 0).any()):
                raise AssertionError(f"serve_models {t}: {name} CSV {vals.shape}, rows {rows}")
            runs[name] = {"vals": vals, "seconds_per_slide": res["serve_seconds"] / len(paths),
                          "main_seconds": time.perf_counter() - t0,
                          "launches": {k: v for k, v in _build.LAUNCHES.items() if v}}
        full, part = runs["kernels"]["vals"], runs["panel"]["vals"]
        cols = full[:, [genes.index(g) for g in panel]]
        panel_rel = float(np.abs(part - cols).max() / np.abs(cols).max())
        if panel_rel > 1e-5:
            raise AssertionError(f"serve_models {t}: panel {panel_rel:.3g} from the full head")
        r_plain = r_min_check(min(pearson(np, full[i], runs["plain"]["vals"][i])
                                  for i in range(len(paths))), 0.99)
        models = cli.load_fold_models(dirs[t], t)
        if t == "vit":
            models = [(dataclasses.replace(c, compute_dtype="bfloat16"), p) for c, p in models]
        pred, line = cli.build_predictor("resnet", "random", models, device=dev,
                                         batch_size=FEAT_BATCH, n_clusters=K, patch_size=PATCH,
                                         model_type=t)
        _build.reset_launches()
        http = post_once(np, pred, genes, paths, {p: full[i] for i, p in enumerate(paths)})
        torch.cuda.synchronize()
        for k, v in _build.LAUNCHES.items():
            launches[k] += v
        out[t] = {"kernels_line": line, "csv_shape": list(full.shape),
                  "panel_shape": list(part.shape), "panel_max_rel_diff": panel_rel,
                  "pearson_r_min_vs_plain": r_plain,
                  **{f"{k}_seconds_per_slide": v["seconds_per_slide"] for k, v in runs.items()},
                  "main_seconds": {k: v["main_seconds"] for k, v in runs.items()},
                  "launches_per_run": {k: v["launches"] for k, v in runs.items()},
                  "http_post": http}
        del pred, models
        torch.cuda.empty_cache()
    return out


def spatial_maps(torch, dev, root: str, dirs: dict, slide, path: str, genes, launches) -> dict:
    """Phase 5's slide 0 in the TCGA layout (the slide file, ``mask.npy`` from
    ``patch_gen.compute_slide_mask``): ``cli.visualize`` at stride 1 on a
    50-gene panel with the five ViS folds, then the HE2RNA and ViT folds (K4
    in the bf16 tile features); then the arrays at every gene: tile features
    with K4 against plain ones, the device window stage timed, and its means
    against the host's float64 means.  Adds the CLI runs' launches to
    ``launches``."""
    import numpy as np
    from sequoia_tpu_torch import _build
    from sequoia_tpu_torch.cli import serve as cli_serve
    from sequoia_tpu_torch.cli import visualize as viz
    from sequoia_tpu_torch.data.wsi import open_slide
    from sequoia_tpu_torch.pipeline import patch_gen, spatial

    panel = genes[::GENES // PANEL][:PANEL]
    mask, _ = patch_gen.compute_slide_mask(slide, device=dev)
    mdir = os.path.join(root, "TCGA", f"{SPATIAL_PROJECT}_Masks", SPATIAL_WSI[:-4])
    os.makedirs(mdir)
    np.save(os.path.join(mdir, "mask.npy"), mask)
    wsi_path = os.path.join(root, "TCGA", SPATIAL_PROJECT, SPATIAL_WSI)
    os.makedirs(os.path.dirname(wsi_path))
    os.link(path, wsi_path)  # the slide file of serve_models, under the layout's name
    res = {"cli": {}}
    args = ["--study", STUDY, "--project", SPATIAL_PROJECT, "--wsi_file_name", SPATIAL_WSI,
            "--feat_type", "resnet", "--folds", ",".join(str(i) for i in range(FOLDS)),
            "--stride", str(SPATIAL_STRIDE), "--patch_size", str(PATCH), "--weights", "random",
            "--batch_size", str(FEAT_BATCH), "--compute_dtype", "bfloat16",
            "--gene_names", ",".join(panel), "--device", dev.type]
    cols = [c for g in panel for c in [f"{g}_{i}" for i in range(FOLDS)] + [g]]
    with contextlib.chdir(root):
        for t in ("vis", "he2rna", "vit"):
            _build.reset_launches()
            t0 = time.perf_counter()
            frame = viz.main([*args, "--model_type", t, "--save_folder", f"maps_{t}"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            for k, v in _build.LAUNCHES.items():
                launches[k] += v
            csv_path = os.path.join("visualizations", SPATIAL_PROJECT, f"maps_{t}", SPATIAL_WSI,
                                    f"stride-{SPATIAL_STRIDE}.csv")
            missing = [c for c in ["xcoord", "ycoord", "xcoord_tf", "ycoord_tf", *cols]
                       if c not in frame.columns]
            if missing:
                raise AssertionError(f"spatial {t}: CSV columns missing {missing[:4]}")
            vals = frame[cols].to_numpy(float)
            covered = ~np.isnan(vals[:, -1])
            if not os.path.exists(csv_path) or covered.sum() == 0 or \
                    not np.isfinite(vals[covered]).all():
                raise AssertionError(f"spatial {t}: {int(covered.sum())} tiles covered")
            for g in panel[:3]:
                folds_mean = frame[[f"{g}_{i}" for i in range(FOLDS)]].mean(axis=1).to_numpy()
                if np.nanmax(np.abs(folds_mean - frame[g].to_numpy())) > 1e-6:
                    raise AssertionError(f"spatial {t}: column {g} is not the fold mean")
            res["cli"][t] = {"seconds": secs, "tiles": len(frame),
                             "tiles_covered": int(covered.sum()), "columns": len(frame.columns),
                             "launches": {k: v for k, v in _build.LAUNCHES.items() if v}}

    slide_file = open_slide(wsi_path)
    df = spatial.build_valid_tiles(mask, slide_file.dimensions, PATCH)
    kw = dict(device=dev, batch_size=FEAT_BATCH, compute_dtype="bfloat16")
    fast = cli_serve.build_extractor("resnet", "random", ["bottleneck_chain"], **kw)
    plain = cli_serve.build_extractor("resnet", "random", [], **kw)
    feats, timed = {}, {}
    for name, ext in (("kernels", fast), ("plain", plain)):
        t0 = time.perf_counter()
        feats[name] = spatial.featurize_tiles(slide_file, df, PATCH, ext, resize_to=PATCH)
        torch.cuda.synchronize()
        timed[name] = time.perf_counter() - t0
    feat_rel = float(np.abs(feats["kernels"] - feats["plain"]).max()
                     / np.abs(feats["plain"]).max())
    if feat_rel > 0.05 or not np.isfinite(feats["kernels"]).all():
        raise AssertionError(f"spatial: K4 tile features {feat_rel:.3g} from plain (> 0.05)")
    del fast, plain
    fold_models, ntok = viz.load_fold_predictors(dirs["vis"], list(range(FOLDS)), "vis", dev)
    windows = spatial.collect_windows(df, stride=SPATIAL_STRIDE)
    tile_feats, every, n = feats["kernels"], list(range(GENES)), len(df)
    spatial.sliding_window_predict_arrays(tile_feats, df, fold_models, every[:8], stride=16,
                                          accumulate="device", num_tokens=ntok)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, sums, counts = spatial.sliding_window_predict_arrays(
        tile_feats, df, fold_models, every, stride=SPATIAL_STRIDE, accumulate="device",
        num_tokens=ntok, _device_sums=True)
    torch.cuda.synchronize()
    windows_s = time.perf_counter() - t0
    if not all(bool(torch.isfinite(v).all()) for v in sums.values()):
        raise AssertionError("spatial: device window sums not finite")
    del sums
    # the forward alone over the same window batches
    table = torch.cat([torch.as_tensor(tile_feats).to(dev),
                       torch.zeros((1, tile_feats.shape[1]), device=dev)])
    t0 = time.perf_counter()
    for s in range(0, len(windows), 64):
        gidx = np.full((64, ntok), n, np.int64)
        for i, sel in enumerate(windows[s:s + 64]):
            gidx[i, :min(len(sel), ntok)] = sel[:ntok]
        fold_models.raw_fwd(table[torch.from_numpy(gidx).to(dev)])
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    del table
    torch.cuda.empty_cache()
    checked = {}
    for acc in ("host", "device"):
        t0 = time.perf_counter()
        checked[acc] = spatial.sliding_window_predict_arrays(
            tile_feats, df, fold_models, every, stride=SPATIAL_HOST_STRIDE, accumulate=acc,
            num_tokens=ntok)
        torch.cuda.synchronize()
        checked[acc + "_s"] = time.perf_counter() - t0
    (hk, hm, hseen), (dk, dm, dseen) = checked["host"], checked["device"]
    if hk != dk or not (hseen == dseen).all():
        raise AssertionError("spatial: the host and device window stages cover other tiles")
    worst = 0.0
    for f in hk:
        a, b = dm[f][hseen], hm[f][hseen]
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)
        worst = max(worst, float(np.abs(a - b).max()))
    res.update(tiles=n, windows=len(windows), stride=SPATIAL_STRIDE, tokens=ntok, genes=GENES,
               folds=FOLDS, tiles_covered=int((counts > 0).sum()),
               featurize_s=timed["kernels"], featurize_plain_s=timed["plain"],
               features_max_rel_diff_vs_plain=feat_rel, windows_s=windows_s,
               window_forward_s=forward_s, accumulate_s=windows_s - forward_s,
               host_vs_device={"stride": SPATIAL_HOST_STRIDE, "windows": len(
                   spatial.collect_windows(df, stride=SPATIAL_HOST_STRIDE)),
                   "host_s": checked["host_s"], "device_s": checked["device_s"],
                   "max_abs_diff": worst, "rtol": 2e-5, "atol": 2e-6})
    return res


def independent(torch, dev, root: str, feat_root: str, vis_dir: str) -> dict:
    """``cli.predict_independent`` with the five ViS folds as a local
    ``{fold}`` template over the phase 8 cohort: ``pred`` and ``random``
    frames of (CV_SLIDES, GENES), finite."""
    import numpy as np
    from sequoia_tpu_torch.cli import predict_independent as cli_pi

    t0 = time.perf_counter()
    out = cli_pi.main(["--ref_file", os.path.join(root, "ref.csv"), "--feature_path",
                       feat_root, "--checkpoint_template",
                       os.path.join(vis_dir, "model_best_{fold}.pt"), "--folds", str(FOLDS),
                       "--save_dir", root, "--exp_name", "indep", "--device", dev.type])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for key in ("pred", "random"):
        v = out[key].to_numpy()
        if v.shape != (CV_SLIDES, GENES) or not np.isfinite(v).all():
            raise AssertionError(f"independent: {key} {v.shape}")
    if not os.path.exists(os.path.join(root, "indep", "test_results.pkl")):
        raise AssertionError("independent: test_results.pkl not written")
    return {"seconds": secs, "pred_shape": list(out["pred"].shape),
            "random_shape": list(out["random"].shape), "finite": True,
            "pred_random_max_abs_diff": float(np.abs(out["pred"].to_numpy()
                                                     - out["random"].to_numpy()).max())}


def aggregators_path(torch, dev) -> dict:
    """Phase 9; returns the kernels' launch counts of its kernel runs (the
    serve CLI and its HTTP POST with ``build_predictor``'s set, and
    cli.visualize's tile features), each read from 0."""
    import shutil
    import tempfile

    import numpy as np
    from sequoia_tpu_torch import _build, native

    t_phase = time.perf_counter()
    launches = {k: 0 for k in _build.LAUNCHES}
    emit({"phase": "he2rna_parity", **he2rna_parity(torch, dev)})
    torch.cuda.empty_cache()
    emit({"phase": "he2rna_step", **he2rna_step(torch, dev)})
    genes = [f"GENE{i:05d}" for i in range(GENES)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_agg_")
    try:
        t0 = time.perf_counter()
        feat_root, store, source = write_cohort(np, tmp)
        cohort = {"slides": CV_SLIDES, "features_from": source,
                  "write_s": time.perf_counter() - t0}
        with feature_store(store):
            emit({"phase": "he2rna_cv", "cohort": cohort,
                  **he2rna_cv(torch, dev, tmp, feat_root)})
        _, vis_folds = models(torch, dev)  # phase 4's folds, from the same seeds
        dirs, write_s = write_fold_dirs(torch, dev, tmp, vis_folds, genes)
        del vis_folds
        torch.cuda.empty_cache()
        slides = [make_slide(torch, dev, s) for s in (1, 2)]  # phase 5's slides
        writer = "native" if native.available() else "pillow"
        paths = [os.path.join(tmp, f"slide{i}.tiff") for i in range(len(slides))]
        for slide, path in zip(slides, paths):
            write_slide_file(slide, path, writer)
        emit({"phase": "serve_models", "fold_write_seconds": write_s, "slide_files_by": writer,
              **serve_models(torch, dev, tmp, dirs, paths, genes, launches)})
        torch.cuda.empty_cache()
        emit({"phase": "spatial", **spatial_maps(torch, dev, tmp, dirs, slides[0], paths[0],
                                                  genes, launches)})
        del slides
        torch.cuda.empty_cache()
        with feature_store(store):
            emit({"phase": "independent",
                  **independent(torch, dev, tmp, feat_root, dirs["vis"])})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check_launched(launches, ("bottleneck_chain", "lloyd_stats"), "aggregators path")
    emit({"phase": "aggregators_launches", **launches,
          "phase_seconds": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# phase 10: the offline stages (tiling, features, k-means) and evaluation
# ---------------------------------------------------------------------------

# the features stage's third slide: STAGE_PATCHES seeded 256-px patches in the
# packed layout, so that compute_features' default cap (STAGE_CAP) binds; its
# extractor batch (the CLI's default)
STAGE_PATCHES, STAGE_CAP, STAGE_BATCH = 4200, 4000, 256
# K4's stage features against the plain ones, relative to max |plain|, by
# compute dtype: f32 sits between K4's f32 reading (1.0e-6) and what a
# TF32 or bf16 product would give; bf16 is PERF.md's 5% agreement rule
STAGE_FEAT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# K5's k-means on the stage's features against float64.  Random-weight
# features of noise and of one texture are near-ties, where one f32 rounding
# can send a Lloyd fit down another path than f64's from the same seeding
# (PERF.md), so the fits' labels and inertia are reported, and the checks
# hold what the kernel computes: K5's final assignment equals the f64 argmin
# to the same centers except where the two f64 distances are within
# STAGE_TIE_GAP (relative) of each other; the written means are the f64
# means of the fit's labels within STAGE_MEANS_TOL of max |mean|; the fit
# is a fixed point: its centers (K5's sums over counts) are the f64 means
# of its final labels within the Lloyd tolerance (sum of squared shifts at
# most tol * mean variance, the loop's own stop rule); and its inertia is
# at most 1 + STAGE_INERTIA_TOL of the f64 fit's
STAGE_TIE_GAP, STAGE_MEANS_TOL, STAGE_INERTIA_TOL = 1e-5, 1e-5, 1e-3
# all_genes.csv's columns after the gene index (evaluation/evaluate_model.py)
EVAL_COLUMNS = ("pred_real_r", "random_real_r", "pearson_p", "Steiger_p", "rmse_pred",
                "rmse_random", "rmse_quantile_norm", "rmse_mean_norm", "fdr_pearson_p",
                "fdr_Steiger_p", "cancer")


class MemoryH5:
    """A dict-backed stand-in for the part of h5py the stage modules call,
    for a machine where h5py does not import: ``File(path, mode)`` with modes
    ``r`` / ``w`` / ``r+`` (a missing file raises OSError; ``w`` truncates and
    leaves an empty file on disk, so that path checks hold), ``keys()`` in
    h5py's order (names sorted byte-wise), ``in``, ``create_dataset`` with
    ``data`` / ``shape`` / ``maxshape`` / ``chunks`` / ``dtype`` (an existing
    name raises), and datasets with ``shape``, ``dtype``, ``resize``, slicing,
    assignment and fancy indexing that, as in h5py, must increase.
    ``files`` maps each absolute path to its {name: array}."""

    def __init__(self):
        self.files: dict[str, dict] = {}

    def File(self, path, mode: str = "r"):  # noqa: N802 (h5py's name)
        return _MemoryFile(self, os.path.abspath(path), mode)

    def copy_tree(self, src: str, dst: str) -> None:
        """Copy the stores under ``src`` to the same places under ``dst``."""
        src, dst = os.path.abspath(src), os.path.abspath(dst)
        for path, data in list(self.files.items()):
            if path.startswith(src + os.sep):
                self.files[dst + path[len(src):]] = {
                    k: {**v, "data": v["data"].copy()} for k, v in data.items()}


class _MemoryFile:
    def __init__(self, h5: MemoryH5, path: str, mode: str):
        if mode == "w":
            with open(path, "wb"):  # raises where h5py would: no such directory
                pass
            h5.files[path] = {}
        elif mode not in ("r", "r+"):
            raise ValueError(f"MemoryH5: mode {mode!r} is not covered")
        elif path not in h5.files:
            raise FileNotFoundError(f"Unable to open file {path} (no such HDF5 store)")
        self._data, self._writable = h5.files[path], mode != "r"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        pass

    def keys(self) -> list:
        return sorted(self._data, key=lambda name: name.encode())

    def __contains__(self, name) -> bool:
        return name in self._data

    def __getitem__(self, name):
        if name not in self._data:
            raise KeyError(f"Unable to open object (object '{name}' doesn't exist)")
        return _MemoryDataset(self._data[name])

    def create_dataset(self, name, shape=None, dtype=None, data=None, maxshape=None,
                       chunks=None):
        import numpy as np

        if not self._writable:
            raise ValueError("Unable to create dataset (no write intent on file)")
        if name in self._data:
            raise ValueError(f"Unable to create dataset (name already exists): {name}")
        arr = np.array(data, dtype=dtype) if data is not None else np.zeros(shape, dtype)
        self._data[name] = {"data": arr, "maxshape": maxshape or arr.shape}
        return _MemoryDataset(self._data[name])


class _MemoryDataset:
    def __init__(self, entry: dict):
        self._entry = entry

    @property
    def shape(self) -> tuple:
        return self._entry["data"].shape

    @property
    def dtype(self):
        return self._entry["data"].dtype

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, idx):
        import numpy as np

        if isinstance(idx, (list, np.ndarray)):
            idx = np.asarray(idx)
            if idx.ndim != 1 or (len(idx) > 1 and not (np.diff(idx) > 0).all()):
                raise TypeError("Indexing elements must be in increasing order")
        return np.array(self._entry["data"][idx])

    def __setitem__(self, idx, value) -> None:
        self._entry["data"][idx] = value

    def resize(self, size: int, axis: int = 0) -> None:
        import numpy as np

        old, limit = self._entry["data"], self._entry["maxshape"][axis]
        if limit is not None and size > limit:
            raise ValueError(f"resize: {size} past maxshape {limit}")
        shape = list(old.shape)
        shape[axis] = size
        new = np.zeros(shape, old.dtype)
        keep = tuple(slice(0, min(a, b)) for a, b in zip(old.shape, shape))
        new[keep] = old[keep]
        self._entry["data"] = new


@contextlib.contextmanager
def memory_h5():
    """A :class:`MemoryH5` in ``sys.modules["h5py"]`` for the length of the
    block, whatever was there restored after it."""
    saved = sys.modules.get("h5py")
    mem = sys.modules["h5py"] = MemoryH5()
    try:
        yield mem
    finally:
        if saved is None:
            sys.modules.pop("h5py", None)
        else:
            sys.modules["h5py"] = saved


def h5_or_memory():
    """Real h5py files where h5py imports (``(nullcontext, "files")``), else
    :func:`memory_h5` for the phase."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        return memory_h5(), "memory (h5py does not import)"
    return contextlib.nullcontext(), "files"


def stage_patch_gen(torch, dev, root: str, kept: list) -> dict:
    """Phase 5's two slides as files, tiled by ``cli.patch_gen.main`` in
    both layouts: patches and seconds per slide, the layouts holding equal
    patches, each slide's count equal to phase 5's ``predict_wsi`` kept count
    (where phase 5 ran)."""
    import h5py
    import numpy as np
    from sequoia_tpu_torch import native
    from sequoia_tpu_torch.cli import patch_gen as cli

    slides = [make_slide(torch, dev, s) for s in (1, 2)]
    writer = "native" if native.available() else "pillow"
    wsi = os.path.join(root, "wsi")
    os.makedirs(wsi)
    ids = [f"TCGA-STG-{i + 1:02d}" for i in range(len(slides))]
    for sid, slide in zip(ids, slides):
        write_slide_file(slide, os.path.join(wsi, f"{sid}.tiff"), writer)
    # warm-up: the slide mask and the tissue screen's kernels on the card
    from sequoia_tpu_torch.ops import masking
    from sequoia_tpu_torch.pipeline import patch_gen

    patch_gen.compute_slide_mask(slides[0], device=dev)
    masking.patch_keep_flags(torch.zeros((64, PATCH, PATCH, 3), dtype=torch.uint8,
                                         device=dev))
    del slides
    res, written = {"slide_files_by": writer}, {}
    for layout in ("tiles", "packed"):
        t0 = time.perf_counter()
        written[layout] = cli.main(["--wsi_path", wsi, "--patch_path",
                                    os.path.join(root, layout), "--mask_path",
                                    os.path.join(root, f"{layout}_masks"), "--layout", layout])
        torch.cuda.synchronize()
        res[f"{layout}_seconds_per_slide"] = (time.perf_counter() - t0) / len(ids)
    for i, sid in enumerate(ids):
        with h5py.File(os.path.join(root, "tiles", sid, f"{sid}.hdf5"), "r") as f:
            tiles = {k: f[k][:] for k in f.keys()}
        with h5py.File(os.path.join(root, "packed", sid, f"{sid}.hdf5"), "r") as f:
            patches, coords = f["patches"][:], f["coords"][:]
        same = len(tiles) == len(patches) == written["tiles"][sid] == written["packed"][sid] \
            and all(np.array_equal(img, tiles.get(f"{x}_{y}")) for img, (x, y)
                    in zip(patches, coords))
        if not same or not 0 < len(tiles) or (kept[i] is not None and len(tiles) != kept[i]):
            raise AssertionError(f"stages_patch_gen: {sid} tiles {len(tiles)}, packed "
                                 f"{len(patches)}, phase 5 kept {kept[i]}")
        masks = [np.load(os.path.join(root, f"{lay}_masks", sid, "mask.npy"))
                 for lay in ("tiles", "packed")]
        if not np.array_equal(*masks):
            raise AssertionError(f"stages_patch_gen: {sid} masks differ between layouts")
    res.update({"slides": len(ids), "patches_per_slide": [written["tiles"][s] for s in ids],
                "phase5_kept": kept, "layouts_equal": True})
    return res


def stage_features(torch, dev, root: str, tiled: list) -> tuple[dict, dict]:
    """A third, packed slide of STAGE_PATCHES seeded patches, then
    ``cli.compute_features.main --weights random`` over the three slides in
    f32 and bf16, with K4 and with ``--kernels off``: seconds per slide,
    slides/hour and ms per extractor batch from its StageTimer, K4's
    features against the plain ones', the cap.  ``tiled``: the patches of
    the two tiled slides.  Returns the line and the launch counts of the K4
    runs."""
    import math

    import h5py
    import numpy as np
    import pandas as pd
    from sequoia_tpu_torch import _build
    from sequoia_tpu_torch.cli import compute_features as cli

    sid = "TCGA-STG-03"
    g = torch.Generator(device=dev).manual_seed(17)
    u8 = torch.randint(0, 256, (STAGE_PATCHES, PATCH, PATCH, 3), generator=g, device=dev,
                       dtype=torch.uint8).cpu().numpy()
    os.makedirs(os.path.join(root, "packed", sid))
    with h5py.File(os.path.join(root, "packed", sid, f"{sid}.hdf5"), "w") as f:
        f.create_dataset("patches", data=u8, chunks=(min(64, STAGE_PATCHES), PATCH, PATCH, 3))
        f.create_dataset("coords", data=np.stack([np.arange(STAGE_PATCHES) % 64 * PATCH,
                                                  np.arange(STAGE_PATCHES) // 64 * PATCH],
                                                 1).astype(np.int64))
    del u8
    ids = ["TCGA-STG-01", "TCGA-STG-02", sid]
    ref = os.path.join(root, "ref.csv")
    pd.DataFrame({"wsi_file_name": [f"{s}.svs" for s in ids], "patient_id": ids,
                  "tcga_project": "TCGA-STG"}).to_csv(ref, index=False)
    n_patches = [*tiled, STAGE_CAP]
    batches = sum(math.ceil(n / STAGE_BATCH) for n in n_patches)
    # warm-up: cuDNN plans and the allocator at the stage's batch, both dtypes
    warm = torch.randint(0, 256, (STAGE_BATCH, PATCH, PATCH, 3), device=dev,
                         dtype=torch.uint8, generator=g)
    for dtype in ("float32", "bfloat16"):
        for stages in (cli.K4_STAGES, ()):
            ext = cli.load_extractor("resnet", "random", STAGE_BATCH, dtype, device=dev,
                                     fused_stages=stages)
            ext.features(warm)
    del warm, ext
    torch.cuda.synchronize()

    runs, feats, launches = {}, {}, {k: 0 for k in _build.LAUNCHES}
    for dtype in ("float32", "bfloat16"):
        for kernels in ("on", "off"):
            out = os.path.join(root, f"features_{dtype}_{kernels}")
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            got = cli.main(["--ref_file", ref, "--patch_data_path", os.path.join(root, "packed"),
                            "--feature_path", out, "--weights", "random", "--compute_dtype",
                            dtype, "--kernels", kernels])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = {k: _build.LAUNCHES[k] - before[k] for k in before}
            if kernels == "on":
                for k, v in counts.items():
                    launches[k] += v
            stages = got["stages"]
            feats[dtype, kernels] = []
            for s in ids:
                with h5py.File(os.path.join(out, "TCGA-STG", s, f"{s}.h5"), "r") as f:
                    feats[dtype, kernels].append(f["resnet_features"][:])
            runs[f"{dtype}_{kernels}"] = {
                "slides": got["slides"], "kernels": got["kernels"], "seconds": secs,
                "seconds_per_slide": secs / len(ids),
                "slides_per_hour": len(ids) / sum(s["seconds"] for s in stages.values()) * 3600,
                "ms_per_batch": stages["extract"]["seconds"] / batches * 1e3,
                "stage_seconds": {k: s["seconds"] for k, s in stages.items()},
                "bottleneck_chain_launches": counts["bottleneck_chain"]}
            shapes = [f.shape for f in feats[dtype, kernels]]
            if got["slides"] != len(ids) or shapes != [(n, D) for n in n_patches] or not all(
                    np.isfinite(f).all() for f in feats[dtype, kernels]):
                raise AssertionError(f"stages_features {dtype} kernels {kernels}: "
                                     f"{got['slides']} slides, shapes {shapes}")
            k4 = dev.type == "cuda" and kernels == "on"
            if got["kernels"] != (["bottleneck_chain"] if k4 else []) or \
                    (counts["bottleneck_chain"] > 0) != k4:
                raise AssertionError(f"stages_features {dtype} kernels {kernels}: K4 "
                                     f"launched {counts['bottleneck_chain']} times")
        rel = [float(np.abs(a - b).max() / np.abs(b).max())
               for a, b in zip(feats[dtype, "on"], feats[dtype, "off"])]
        runs[f"{dtype}_on"]["features_max_rel_diff_vs_plain"] = rel
        runs[f"{dtype}_on"]["features_tol"] = STAGE_FEAT_TOL[dtype]
        if max(rel) > STAGE_FEAT_TOL[dtype]:
            raise AssertionError(f"stages_features {dtype}: K4 features {rel} off the plain "
                                 f"(> {STAGE_FEAT_TOL[dtype]})")
    res = {"slides": len(ids), "patches_per_slide": n_patches, "cap": STAGE_CAP,
           "packed_patches": STAGE_PATCHES, "batch": STAGE_BATCH, "batches": batches,
           "runs": runs, "k4_launches_per_batch": launches["bottleneck_chain"] / 2 / batches}
    return res, launches


def lloyd_f64_check(torch, dev, km, feats, written: dict) -> dict:
    """One slide's hybrid seeding, then Lloyd with K5 and plain f32 (f32
    operands) and on f64 operands.  For each f32 backend (``written``: its
    CLI's cluster features): steps, the share of labels equal to the f64
    fit's, its final assignment against the f64 argmin to the same centers
    (points off it, and of those the ones not at an f64 near-tie), its means
    against the f64 means of its labels, its centers' squared shift to
    those means beside the Lloyd tolerance, its inertia over the f64 fit's."""
    x32 = torch.as_tensor(feats, device=dev)
    x64 = x32.double()
    mask = torch.ones((x32.shape[0],), dtype=torch.bool, device=dev)
    init = torch.as_tensor(km.sklearn_plusplus_centers(feats, K, 0), device=dev)

    def sq_dists(c):  # (N, K) in f64
        c = c.double()
        return ((x64 * x64).sum(1, keepdim=True) + (c * c).sum(1)
                - 2.0 * x64 @ c.T).clamp_min(0.0)

    fits = {}
    for name, dtype, kernel in (("plain_f64", torch.float64, False),
                                ("lloyd_stats", torch.float32, True),
                                ("plain", torch.float32, False)):
        x = x32.to(dtype)
        centers, labels, _, steps = km._lloyd(x, mask, init.to(dtype), 300,
                                              km._tol_abs(x, mask, 1e-4), kernel)
        fits[name] = (centers, labels, steps)
    c64, l64, steps64 = fits["plain_f64"]
    inertia64 = float(sq_dists(c64).gather(1, l64[:, None]).sum())
    out = {"steps_f64": steps64, "lloyd_tol_abs": float(km._tol_abs(x64, mask, 1e-4))}
    for name, kernel in (("lloyd_stats", True), ("plain", False)):
        centers, labels, steps = fits[name]
        final = km._stats_fn(x32, mask, kernel)(centers)[3]  # the backend's own argmin
        d2 = sq_dists(centers)
        best = d2.min(1).values
        off = final != d2.argmin(1)
        gap = (d2.gather(1, final[:, None])[:, 0] - best) / best.clamp_min(1e-30)
        m64 = km.cluster_means(x64, labels, mask, K)
        means = torch.as_tensor(written[name], device=dev).double()
        out[name] = {
            "steps": steps, "labels_equal_f64_fit": float((labels == l64).double().mean()),
            "assignment_off_f64_argmin": int(off.sum()),
            "assignment_off_beyond_tie_gap": int((off & (gap > STAGE_TIE_GAP)).sum()),
            "off_max_rel_gap": float(gap[off].max()) if bool(off.any()) else 0.0,
            "means_max_rel_diff_f64": float((means - m64).abs().max() / m64.abs().max()),
            "fixed_point_shift": float(((centers.double() - m64) ** 2).sum()),
            "inertia_over_f64_fit": float(d2.gather(1, labels[:, None]).sum()) / inertia64}
    return out


def stage_kmeans(torch, dev, root: str, mem) -> tuple[dict, dict]:
    """``cli.kmean_features.main`` over the f32 K4 features: the hybrid
    backend with K5 and with ``--kernels off`` (each on its own copy), then
    the device backend with K5; K5's fits against float64
    (:func:`lloyd_f64_check`), and a second K5 run that writes nothing.
    Returns the line and the K5 runs' launch counts."""
    import shutil

    import h5py
    import numpy as np
    from sequoia_tpu_torch import _build
    from sequoia_tpu_torch.cli import kmean_features as cli
    from sequoia_tpu_torch.ops import kmeans as km

    src = os.path.join(root, "features_float32_on")
    ids = ["TCGA-STG-01", "TCGA-STG-02", "TCGA-STG-03"]
    ref = os.path.join(root, "ref.csv")
    launches = {k: 0 for k in _build.LAUNCHES}
    res, written = {}, {}

    def h5(dirname, sid):
        return os.path.join(root, dirname, "TCGA-STG", sid, f"{sid}.h5")

    for label, backend, kernels in (("hybrid_k5", "hybrid", "on"),
                                    ("hybrid_plain", "hybrid", "off"),
                                    ("device_k5", "device", "on")):
        dst = os.path.join(root, f"kmeans_{label}")
        shutil.copytree(src, dst)
        if mem is not None:
            mem.copy_tree(src, dst)
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        got = cli.main(["--ref_file", ref, "--feature_path", dst, "--backend", backend,
                        "--kernels", kernels])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {k: _build.LAUNCHES[k] - before[k] for k in before}
        if kernels == "on":
            for k, v in counts.items():
                launches[k] += v
        written[label] = []
        for sid in ids:
            with h5py.File(h5(f"kmeans_{label}", sid), "r") as f:
                written[label].append(f["cluster_features"][:])
        if got["slides"] != len(ids) or any(cf.shape != (K, D) or not np.isfinite(cf).all()
                                            for cf in written[label]):
            raise AssertionError(f"stages_kmeans {label}: {got['slides']} slides")
        k5 = dev.type == "cuda" and kernels == "on"
        if got["kernels"] != (["lloyd_stats"] if k5 else []) or \
                (counts["lloyd_stats"] > 0) != k5:
            raise AssertionError(f"stages_kmeans {label}: K5 launched "
                                 f"{counts['lloyd_stats']} times")
        res[label] = {"seconds": secs, "seconds_per_slide": secs / len(ids),
                      "kernels": got["kernels"], "lloyd_stats_launches": counts["lloyd_stats"]}

    again = cli.main(["--ref_file", ref, "--feature_path", os.path.join(root, "kmeans_hybrid_k5"),
                      "--backend", "hybrid"])
    for sid, cf in zip(ids, written["hybrid_k5"]):
        with h5py.File(h5("kmeans_hybrid_k5", sid), "r") as f:
            if not np.array_equal(f["cluster_features"][:], cf, equal_nan=True):
                raise AssertionError(f"stages_kmeans: the second run changed {sid}")
    if again["slides"] != 0:
        raise AssertionError(f"stages_kmeans: the second run clustered {again['slides']}")

    checks = []
    for i, sid in enumerate(ids):
        with h5py.File(h5("kmeans_hybrid_k5", sid), "r") as f:
            feats = f["resnet_features"][:]
        row = {"slide": sid, "patches": len(feats),
               **lloyd_f64_check(torch, dev, km, feats, {
                   "lloyd_stats": written["hybrid_k5"][i],
                   "plain": written["hybrid_plain"][i]})}
        k5 = row["lloyd_stats"]
        if k5["assignment_off_beyond_tie_gap"] or k5["means_max_rel_diff_f64"] > STAGE_MEANS_TOL \
                or not k5["fixed_point_shift"] <= row["lloyd_tol_abs"] \
                or not k5["inertia_over_f64_fit"] <= 1 + STAGE_INERTIA_TOL:
            raise AssertionError(f"stages_kmeans: K5 off float64 on {sid}: {row}")
        checks.append(row)
    res.update({"against_f64": checks, "second_run_clustered": again["slides"],
                "k5_launches_per_slide": res["hybrid_k5"]["lloyd_stats_launches"] / len(ids)})
    return res, launches


def stage_evaluate(torch, dev, root: str, test_results) -> dict:
    """``cli.evaluate_model.main`` over a five-fold ``test_results.pkl`` that
    the port's CV wrote on the card: phase 8's (``test_results``, pickled
    bytes), or else a 1-epoch ``cli.main`` CV on phase 8's cohort."""
    import numpy as np
    from sequoia_tpu_torch.cli import evaluate_model as cli

    model_dir = os.path.join(root, "eval")
    os.makedirs(os.path.join(model_dir, "syn"))
    res = {"test_results_from": "phase 8 train_cv"}
    if test_results is None:
        from sequoia_tpu_torch.cli import main as cli_main

        cohort = os.path.join(root, "cohort")
        os.makedirs(cohort)
        feat_root, store, source = write_cohort(np, cohort)
        t0 = time.perf_counter()
        with feature_store(store):
            cli_main.main(["--ref_file", os.path.join(cohort, "ref.csv"), "--feature_path",
                           feat_root, "--model_type", "vis", "--train", "--k", "5",
                           "--num_epochs", "1", "--filter_no_features", "0", "--save_dir",
                           os.path.join(cohort, "exp"), "--exp_name", "cv", "--batch_size",
                           str(TRAIN_BATCH), "--lr", str(TRAIN_LR)])
        torch.cuda.synchronize()
        res = {"test_results_from": f"1-epoch cli.main CV, features from {source}",
               "cv_seconds": time.perf_counter() - t0}
        with open(os.path.join(cohort, "exp", "TCGA", "cv", "test_results.pkl"), "rb") as f:
            test_results = f.read()
    with open(os.path.join(model_dir, "syn", "test_results.pkl"), "wb") as f:
        f.write(test_results)
    t0 = time.perf_counter()
    all_res, sig_res = cli.main(["--model_dir", model_dir, "--cancers", "syn"])
    secs = time.perf_counter() - t0
    import pandas as pd

    on_disk = pd.read_csv(os.path.join(model_dir, "results", "all_genes.csv"), index_col=0)
    if len(on_disk) != GENES or tuple(on_disk.columns) != EVAL_COLUMNS or \
            len(all_res) != GENES or not np.isfinite(on_disk["pred_real_r"]).all():
        raise AssertionError(f"stages_evaluate: all_genes.csv {on_disk.shape}, columns "
                             f"{list(on_disk.columns)}")
    for name in ("sig_genes.csv", "num_sign_genes.csv"):
        if not os.path.exists(os.path.join(model_dir, "results", name)):
            raise AssertionError(f"stages_evaluate: {name} not written")
    res.update({"seconds": secs, "genes": len(on_disk), "columns": list(on_disk.columns),
                "significant": len(sig_res),
                "pred_real_r_max": float(on_disk["pred_real_r"].max())})
    return res


def stages_path(torch, dev, kept: list, test_results=None) -> dict:
    """Phase 10; returns the kernels' launch counts of its kernel runs (the
    features stage with K4, the k-means stage with K5)."""
    import shutil
    import tempfile

    from sequoia_tpu_torch import _build

    t_phase = time.perf_counter()
    launches = {k: 0 for k in _build.LAUNCHES}
    ctx, store = h5_or_memory()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_stages_")
    try:
        with ctx as mem:
            line = stage_patch_gen(torch, dev, tmp, kept)
            emit({"phase": "stages_patch_gen", "h5": store, **line})
            line, counts = stage_features(torch, dev, tmp, line["patches_per_slide"])
            emit({"phase": "stages_features", "h5": store, **line})
            for k, v in counts.items():
                launches[k] += v
            torch.cuda.empty_cache()
            line, counts = stage_kmeans(torch, dev, tmp, mem)
            emit({"phase": "stages_kmeans", "h5": store, **line})
            for k, v in counts.items():
                launches[k] += v
        del mem  # the stand-in's stores (the packed slide alone is 826 MB)
        emit({"phase": "stages_evaluate", **stage_evaluate(torch, dev, tmp, test_results)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check_launched(launches, ("bottleneck_chain", "lloyd_stats"), "stages path")
    emit({"phase": "stages_launches", "h5": store, **launches,
          "phase_seconds": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# phase 11: multi-GPU and multi-host paths on one card
# ---------------------------------------------------------------------------

# the sharded train step at full width: the reference's batch of 16 over
# (100, 2048) cluster features, the 20,820-gene head, PAR_STEPS AdamW steps;
# a world of one against the unsharded loop within PAR_REL, two gloo ranks
# against one process: loss and mae at 1e-5, corr and every leaf's first
# AdamW moment (max |diff| / max |single|) at 1e-4, the CPU tests'
# tolerances (tests/test_multihost.py:95-98, tests/test_torch_multihost.py);
# every parameter leaf's update after the steps, ||sharded - single|| /
# ||single - initial||, at PAR_UPDATE_RTOL.  Not the parameters' max
# relative error: AdamW's first steps move an element by about lr whatever
# its gradient's size, so an element whose gradient cancels to rounding
# moves by a different few % of lr under any change of summation order
# (pure data parallelism included); it is printed, not held
PAR_STEPS, PAR_TIMED, PAR_REL = 2, 5, 1e-6
PAR_LOSS_RTOL, PAR_CORR_RTOL, PAR_UPDATE_RTOL = 1e-5, 1e-4, 1e-3
# the data-parallel checks: a feature, prediction or map over a (2, 1) mesh
# of the card against one device at the per-device batch (the same shapes
# through the same kernels), max |dp - single| / max |single|; only the
# window sums (chunks of another length) and the (1, 2) head's column
# blocks may reorder f32 sums
PAR_DP_TOL = 1e-5
# the fleet CLIs' slide side and patch store
PAR_SLIDE_SIDE, PAR_FLEET_PATCHES = 2048, 64


def par_case(torch, dev):
    """The full-width ViS (f32), its apply and PAR_STEPS batches, drawn on
    the card from seeds (equal in every process on the card).  The targets
    are the model's first prediction plus unit noise, so the mean per-gene
    r is far from 0 and its relative error means something."""
    from sequoia_tpu_torch.data.dataset import Batch

    cfg, params, apply_fn = train_model(torch, dev, "vis", seed=1100)
    g = torch.Generator(device=dev).manual_seed(1101)
    batches = []
    for _ in range(PAR_STEPS):
        x, y, v = batch_on(torch, dev, g, D, GENES)
        with torch.no_grad():
            pred = apply_fn(params, x)
        y = pred / pred.std() + y
        batches.append(Batch(x.cpu().numpy(), y.cpu().numpy(), v.cpu().numpy(),
                             [""] * TRAIN_BATCH, [""] * TRAIN_BATCH))
    return cfg, params, apply_fn, batches


def par_rank(tmp: str, device: str) -> dict:
    """One of two gloo ranks on cuda:0: PAR_STEPS sharded steps over the
    (data=1, model=2) mesh and over the (data=2, model=1) mesh of the same
    world, the whole parameters and first moments after them (gathered)
    against the same steps unsharded (run here first), each rank's head and
    AdamW-moment bytes, and a ``torch.distributed.checkpoint``
    round trip of the (1, 2) state (saved there, loaded there and on the
    (2, 1) mesh)."""
    import torch
    from sequoia_tpu_torch.ops.nn import precision
    from sequoia_tpu_torch.parallel import multihost as mh
    from sequoia_tpu_torch.parallel import sharding as sh
    from sequoia_tpu_torch.train import checkpoint, loop

    precision()
    dev = torch.device(device)
    cfg, full, apply_fn, batches = par_case(torch, dev)
    p1 = loop.tree_map(lambda t: t.detach().clone().requires_grad_(True), full)
    opt1 = loop.make_adamw(p1, lr=TRAIN_LR)
    step1, _ = loop.make_step_fns(apply_fn, opt1)
    for b in batches:
        step1(p1, *(torch.from_numpy(a).to(dev) for a in (b.features, b.rna, b.valid)))
    def named(tree):
        return dict(zip(leaf_paths(tree), loop.tree_leaves(tree)))

    single = {"params": named(p1),
              "mu": named(loop.tree_map(lambda t: opt1.state[t]["exp_avg"], p1))}
    del opt1, step1
    out, whole = {}, None
    path = os.path.join(tmp, "dcp")
    for n_model in (2, 1):
        mesh = mh.make_global_mesh(n_model=n_model, device=dev, local_size=2)
        p = loop.tree_map(lambda t: t.requires_grad_(True), sh.shard_params(mesh, full))
        opt = loop.make_adamw(p, lr=TRAIN_LR)
        step, _ = loop.make_sharded_step_fns(apply_fn, opt, mesh, apply_fn.head_input)
        metrics = []
        for b in batches:
            args = sh.shard_batch_arrays(mesh, *(torch.from_numpy(a) for a in (
                b.features, b.rna, b.valid)))
            metrics.append({k: float(v) for k, v in step(p, *args).items()})
        mu = loop.tree_map(lambda t: opt.state[t]["exp_avg"], p)
        # per leaf max |sharded - single| / max |single|; the update's norm
        rel, upd, init = {}, {}, named(full)
        for k, t in (("params", p), ("mu", mu)):
            rel[k] = {}
            for leaf, a in named(sh.gather_params(mesh, t)).items():
                a, b = a.detach().float(), single[k][leaf].detach().float()
                rel[k][leaf] = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                if k == "params":
                    upd[leaf] = float((a - b).norm()
                                      / (b - init[leaf].float()).norm().clamp(min=1e-30))
        worst_leaf = max(rel["params"], key=rel["params"].get)
        res = {"metrics": metrics, "update_max_rel": max(upd.values()),
               "moments_max_rel": max(rel["mu"].values()),
               "params_max_rel": [worst_leaf, rel["params"][worst_leaf]],
               "head_bytes": p["head_w"].numel() * p["head_w"].element_size(),
               "moment_bytes": sum(opt.state[p["head_w"]][k].numel() * 4
                                   for k in ("exp_avg", "exp_avg_sq"))}
        state = {"params": p, "mu": mu}
        state_specs = {"params": sh.param_pspecs(p), "mu": sh.param_pspecs(mu)}
        like = loop.tree_map(torch.zeros_like, state)
        if n_model == 2:
            mh.barrier(mesh)
            t0 = time.perf_counter()
            checkpoint.save_sharded(path, state, mesh, state_specs)
            res["dcp_save_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = checkpoint.load_sharded(path, like, mesh, state_specs)
            res["dcp_load_s"] = time.perf_counter() - t0
            res["dcp_bit_equal"] = all(torch.equal(a, b) for a, b in zip(
                loop.tree_leaves(got), loop.tree_leaves(state)))
            whole = {k: sh.gather_params(mesh, v) for k, v in state.items()}
        else:  # the (1, 2) checkpoint read into the (2, 1) layout: the whole head
            t0 = time.perf_counter()
            got = checkpoint.load_sharded(path, like, mesh, state_specs)
            res["dcp_reshard_load_s"] = time.perf_counter() - t0
            res["dcp_reshard_bit_equal"] = all(torch.equal(a, b) for a, b in zip(
                loop.tree_leaves(got), loop.tree_leaves(whole)))
        out[f"{mesh.shape['data']}x{n_model}"] = res
    return out


def par_train(torch, dev) -> dict:
    """Items 1 and 2 of phase 11: the sharded train loop in an NCCL world of
    one against the unsharded loop, ms per step both ways with the
    all-reduce bytes per step, then two gloo ranks on the card."""
    import functools
    import tempfile

    import torch.distributed as dist
    from sequoia_tpu_torch.parallel import multihost as mh
    from sequoia_tpu_torch.parallel import sharding as sh
    from sequoia_tpu_torch.train import loop

    cfg, full, apply_fn, batches = par_case(torch, dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_par_")
    res = {}
    try:
        t0 = time.perf_counter()
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="file://" + os.path.join(tmp, "store"),
                                world_size=1, rank=0)
        mesh = mh.make_global_mesh(n_model=1, device=dev)
        mh.barrier(mesh)
        torch.cuda.synchronize()
        res["nccl_init_s"] = time.perf_counter() - t0
        kw = dict(num_epochs=1, phases=("train",), verbose=False, prefetch_depth=0)
        opt = functools.partial(loop.make_adamw, lr=TRAIN_LR)
        runs = {}
        for name, m in (("sharded", mesh), ("unsharded", None)):
            r = loop.train(apply_fn, full, opt, {"train": batches}, mesh=m, device=dev, **kw)
            runs[name] = (r.history[0]["train"], r.final_params)
        (hs, ps), (hu, pu) = runs["sharded"], runs["unsharded"]
        m_rel = max(abs(hs[k] - hu[k]) / max(abs(hu[k]), 1e-30) for k in hu)
        p_rel = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                    for a, b in zip(loop.tree_leaves(ps), loop.tree_leaves(pu)))
        if m_rel > PAR_REL or p_rel > PAR_REL:
            raise AssertionError(f"parallel_train: world of one off the unsharded loop: "
                                 f"metrics {m_rel:.3g}, params {p_rel:.3g} > {PAR_REL:g}")
        res["world1"] = {"steps": PAR_STEPS, "metrics": hs, "metrics_max_rel": m_rel,
                         "params_max_rel": p_rel, "tol": PAR_REL}

        # ms per step: CUDA events over PAR_TIMED steps after one warm-up
        arrays = [tuple(torch.from_numpy(a) for a in (b.features, b.rna, b.valid))
                  for b in batches]
        timing = {}
        for name in ("sharded", "unsharded"):
            if name == "sharded":
                p = loop.tree_map(lambda t: t.requires_grad_(True), sh.shard_params(mesh, full))
                step, _ = loop.make_sharded_step_fns(apply_fn, loop.make_adamw(p, lr=TRAIN_LR),
                                                     mesh)
                args = [sh.shard_batch_arrays(mesh, *a) for a in arrays]
            else:
                p = loop.tree_map(lambda t: t.detach().clone().requires_grad_(True), full)
                step, _ = loop.make_step_fns(apply_fn, loop.make_adamw(p, lr=TRAIN_LR))
                args = [tuple(t.to(dev) for t in a) for a in arrays]
            step(p, *args[0])
            torch.cuda.synchronize()
            calls, nbytes = mh.COLLECTIVES["calls"], mh.COLLECTIVES["bytes"]
            t = time_ms(torch, lambda: step(p, *args[1 % len(args)]), PAR_TIMED)
            timing[name] = {"ms_per_step": t,
                            "all_reduces_per_step": (mh.COLLECTIVES["calls"] - calls)
                            / (PAR_TIMED + 1),
                            "all_reduce_bytes_per_step": (mh.COLLECTIVES["bytes"] - nbytes)
                            / (PAR_TIMED + 1)}
            del p, step, args
        res["timing"] = timing
        res["head_shard_mib"] = full["head_w"].numel() * 4 / 2**20
        dist.destroy_process_group()
        torch.cuda.empty_cache()

        # two gloo ranks sharing the card: (1, 2) and (2, 1) against one process
        p = loop.tree_map(lambda t: t.detach().clone().requires_grad_(True), full)
        step, _ = loop.make_step_fns(apply_fn, loop.make_adamw(p, lr=TRAIN_LR))
        single = [{k: float(v) for k, v in step(p, *(t.to(dev) for t in a)).items()}
                  for a in arrays]
        del p, step, full
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        one = "cuda:0" if dev.type == "cuda" else "cpu"
        ranks = mh.spawn_local(par_rank, 2, (tmp, one), backend="gloo", devices=[one, one],
                               timeout=600.0)
        gloo = {"seconds": time.perf_counter() - t0, "single_metrics": single}
        full_bytes = 4 * D * GENES
        for name in ranks[0]:
            worst = {"loss": 0.0, "corr": 0.0, "mae": 0.0}
            for r in ranks:
                for got, want in zip(r[name]["metrics"], single):
                    for k in worst:
                        worst[k] = max(worst[k], abs(got[k] - want[k]) / abs(want[k]))
            n_model = int(name.split("x")[1])
            heads = [r[name]["head_bytes"] for r in ranks]
            moments = [r[name]["moment_bytes"] for r in ranks]
            u_rel = max(r[name]["update_max_rel"] for r in ranks)
            mu_rel = max(r[name]["moments_max_rel"] for r in ranks)
            gloo[name] = {"metrics_max_rel": worst, "update_max_rel": u_rel,
                          "moments_max_rel": mu_rel,
                          "params_max_rel": ranks[0][name]["params_max_rel"],
                          "head_bytes_per_rank": heads,
                          "moment_bytes_per_rank": moments,
                          **{k: v for k, v in ranks[0][name].items()
                             if k.startswith("dcp")}}
            if (max(worst["loss"], worst["mae"]) > PAR_LOSS_RTOL
                    or max(worst["corr"], mu_rel) > PAR_CORR_RTOL or u_rel > PAR_UPDATE_RTOL):
                raise AssertionError(f"parallel_gloo {name}: {worst}, moments {mu_rel:.3g}, "
                                     f"updates {u_rel:.3g} past loss and mae "
                                     f"{PAR_LOSS_RTOL:g} / corr and moments {PAR_CORR_RTOL:g} "
                                     f"/ updates {PAR_UPDATE_RTOL:g}")
            if any(h * n_model != full_bytes for h in heads) or any(
                    m * n_model != 2 * full_bytes for m in moments):
                raise AssertionError(f"parallel_gloo {name}: head {heads} / moments {moments} "
                                     f"bytes are not 1/{n_model} of the whole")
            for key in ("dcp_bit_equal", "dcp_reshard_bit_equal"):
                if any(r[name].get(key) is False for r in ranks):
                    raise AssertionError(f"parallel_dcp {name}: {key} fails")
        res["gloo"] = gloo
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil_rmtree(tmp)
    return res


def shutil_rmtree(path: str) -> None:
    import shutil

    shutil.rmtree(path, ignore_errors=True)


def rel_diff(torch, a, b) -> float:
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def par_dp(torch, dev, folds, launches: dict) -> dict:
    """Item 3: in-process data parallelism over a (2, 1) mesh of the one
    card against the same call on the card alone at the per-device batch:
    K4 extraction
    (``load_extractor(data_parallel=True)``), a serving slide through K4,
    K5 and K1, the window stage over (2, 1) and (1, 2), and one batch
    through K2 and K3.  Adds the data-parallel runs' launches to
    ``launches``."""
    import numpy as np
    import pandas as pd
    from sequoia_tpu_torch import _build
    from sequoia_tpu_torch.cli import serve as cli
    from sequoia_tpu_torch.cli.compute_features import load_extractor
    from sequoia_tpu_torch.models import resnet
    from sequoia_tpu_torch.parallel import sharding as sh
    from sequoia_tpu_torch.pipeline import spatial
    from sequoia_tpu_torch.pipeline.features import FeatureExtractor

    two = [dev, dev]
    res = {}

    def counted(fn):
        before = dict(_build.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        for k in launches:
            launches[k] += _build.LAUNCHES[k] - before[k]
        return out

    def held(name, got, want, extra=None):
        rel = rel_diff(torch, got, want)
        res[name] = {"max_rel_diff": rel, "bit_equal": bool(torch.equal(
            torch.as_tensor(got), torch.as_tensor(want))), "tol": PAR_DP_TOL, **(extra or {})}
        if not rel <= PAR_DP_TOL:
            raise AssertionError(f"parallel_dp {name}: {rel:.3g} > {PAR_DP_TOL:g}")

    g = torch.Generator(device=dev).manual_seed(1110)
    u8 = torch.randint(0, 256, (FEAT_BATCH, PATCH, PATCH, 3), generator=g, device=dev,
                       dtype=torch.uint8)
    kw = dict(device=dev, fused_stages=(1, 2, 3, 4))
    half = FEAT_BATCH // 2
    one = load_extractor("resnet", "random", half, "bfloat16", **kw)
    dp = load_extractor("resnet", "random", FEAT_BATCH, "bfloat16", True, devices=two, **kw)
    before = launches["bottleneck_chain"]
    held("extractor_k4", counted(lambda: dp.features(u8)), one.features(u8),
         {"mesh": dp.mesh.shape, "k4_launches": launches["bottleneck_chain"] - before})
    del one, dp

    params = resnet.random_params(torch.Generator(device=dev).manual_seed(1111))
    cfg = resnet.ResNetConfig(compute_dtype=torch.bfloat16, early_pallas=True, cp_stages=(2, 3, 4))
    one = FeatureExtractor("resnet", params, batch_size=half, cfg=cfg, device=dev)
    dp = FeatureExtractor("resnet", params, batch_size=FEAT_BATCH, cfg=cfg,
                          mesh=sh.make_mesh(2, 1, two))
    before = {k: launches[k] for k in ("stem16", "bottleneck_chain_cp")}
    held("extractor_k2_k3", counted(lambda: dp.features(u8)), one.features(u8),
         {k + "_launches": launches[k] - before[k] for k in before})
    del one, dp, params, u8

    kwp = dict(device=dev, batch_size=FEAT_BATCH, n_clusters=K, patch_size=PATCH)
    models = [(dataclasses.replace(c, compute_dtype="bfloat16"), p) for c, p in folds]
    fast, _ = cli.build_predictor("resnet", "random", models, **{**kwp, "batch_size": half})
    dpp, line = cli.build_predictor("resnet", "random", models, data_parallel=True,
                                    devices=two, **kwp)
    slide = make_slide(torch, dev, 1)
    warm = torch.randint(0, 256, (FEAT_BATCH, PATCH, PATCH, 3), generator=g, device=dev,
                         dtype=torch.uint8)
    for p in (fast, dpp):  # cuDNN plans and the allocator at both batches first
        p.predict_patches(warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = counted(lambda: dpp.predict_wsi(slide))
    dp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = fast.predict_wsi(slide)
    torch.cuda.synchronize()
    held("serving_slide", got, want, {"kernels_line": line, "seconds_dp": dp_s,
                                      "seconds_single": time.perf_counter() - t0})
    del fast, dpp, slide

    side, ntok = 24, K
    xs, ys = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    df = pd.DataFrame({"xcoord_tf": xs.ravel(), "ycoord_tf": ys.ravel()})
    feats = torch.randn((side * side, D), generator=g, device=dev).cpu().numpy()
    fold_params = {i: p for i, (_, p) in enumerate(folds)}
    vcfg = folds[0][0]
    genes = np.arange(GENES)
    plain = spatial.make_vis_stacked_predict_fn(vcfg, fold_params)
    wants = {nd: spatial.sliding_window_predict_arrays(
        feats, df, plain, genes, num_tokens=ntok, accumulate="device",
        batch_windows=64 // nd)[1] for nd in (1, 2)}
    for shape in ((2, 1), (1, 2)):
        want = wants[shape[0]]
        mesh = sh.make_mesh(*shape, devices=two)
        multi = spatial.make_vis_stacked_predict_fn(vcfg, fold_params, mesh=mesh)
        t0 = time.perf_counter()
        _, got, _ = counted(lambda: spatial.sliding_window_predict_arrays(
            feats, df, multi, genes, num_tokens=ntok, accumulate="device", mesh=mesh))
        cell = multi.raw_fwd.cells[0][0]
        head = sum(p["head_w"].numel() * p["head_w"].element_size() for p in cell.values())
        held(f"windows_{shape[0]}x{shape[1]}", np.stack([got[f] for f in sorted(got)]),
             np.stack([want[f] for f in sorted(want)]),
             {"seconds": time.perf_counter() - t0, "head_mib_per_device": head / 2**20})
        del multi
    return res


def par_fleet(torch, dev, folds, launches: dict) -> dict:
    """Item 4: ``cli.serve --multihost`` and ``cli.compute_features
    --multihost`` in a gloo world of one (a file store through
    ``--coordinator``): the part file equals the CSV without the flag, and
    the feature fleet covers every row."""
    import pickle
    import tempfile

    import numpy as np
    import pandas as pd
    import torch.distributed as dist
    from sequoia_tpu_torch import _build
    from sequoia_tpu_torch.cli import compute_features as cf_cli
    from sequoia_tpu_torch.cli import serve as cli
    from sequoia_tpu_torch.models import convert, vis
    from sequoia_tpu_torch.train import checkpoint

    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    res = {}

    def fleet(name):
        return ["--multihost", "--coordinator", "file://" + os.path.join(tmp, f"store_{name}"),
                "--num_processes", "1", "--process_id", "0"]

    def counted(fn):
        before = dict(_build.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        for k in launches:
            launches[k] += _build.LAUNCHES[k] - before[k]
        return out

    try:
        genes = [f"GENE{i:05d}" for i in range(PANEL)]
        cfg, params = vis.slice_head(*folds[0], list(range(PANEL)))
        exp = os.path.join(tmp, "exp")
        checkpoint.save_torch_state_dict(convert.vis_to_torch(cfg, params),
                                         os.path.join(exp, "model_best_0.pt"))
        with open(os.path.join(exp, "test_results.pkl"), "wb") as f:
            pickle.dump({"genes": genes}, f)
        try:
            import PIL  # noqa: F401

            writer = "pillow"
        except ImportError:
            writer = None
        if writer is not None:
            path = os.path.join(tmp, "slide.tiff")
            write_slide_file(make_slide(torch, dev, 3, side=PAR_SLIDE_SIDE), path, writer)
            args = ["--wsi", path, "--checkpoints", exp, "--weights", "random",
                    "--batch_size", str(FEAT_BATCH), "--num_clusters", str(K),
                    "--patch_size", str(PATCH), "--device", dev.type]
            plain = os.path.join(tmp, "preds.csv")
            cli.main([*args, "--out", plain])
            t0 = time.perf_counter()
            got = counted(lambda: cli.main([*args, "--out", plain, *fleet("serve")]))
            secs = time.perf_counter() - t0
            dist.destroy_process_group()
            part = os.path.join(tmp, "preds.part0.csv")
            a, b = read_csv(part), read_csv(plain)
            same = a[0] == b[0] and a[1] == b[1] and np.array_equal(a[2], b[2])
            res["serve_multihost"] = {"out": os.path.basename(got["out"]), "slides": got["slides"],
                                      "seconds": secs, "equal_to_plain_csv": same}
            if not same:
                raise AssertionError("parallel_fleet: serve --multihost .part0 differs from "
                                     "the CSV without the flag")
        else:
            res["serve_multihost"] = "skipped: no slide writer (Pillow does not import)"

        ctx, source = h5_or_memory()
        with ctx:
            import h5py

            ids = ["TCGA-FLT-01", "TCGA-FLT-02"]
            g = torch.Generator(device=dev).manual_seed(1120)
            for sid in ids:
                u8 = torch.randint(0, 256, (PAR_FLEET_PATCHES, PATCH, PATCH, 3), generator=g,
                                   device=dev, dtype=torch.uint8).cpu().numpy()
                os.makedirs(os.path.join(tmp, "packed", sid))
                with h5py.File(os.path.join(tmp, "packed", sid, f"{sid}.hdf5"), "w") as f:
                    f.create_dataset("patches", data=u8)
                    f.create_dataset("coords", data=np.stack(
                        [np.arange(PAR_FLEET_PATCHES) * PATCH,
                         np.zeros(PAR_FLEET_PATCHES, np.int64)], 1).astype(np.int64))
            ref = os.path.join(tmp, "ref.csv")
            pd.DataFrame({"wsi_file_name": [f"{s}.svs" for s in ids], "patient_id": ids,
                          "tcga_project": "TCGA-FLT"}).to_csv(ref, index=False)
            out = os.path.join(tmp, "features")
            t0 = time.perf_counter()
            got = counted(lambda: cf_cli.main([
                "--ref_file", ref, "--patch_data_path", os.path.join(tmp, "packed"),
                "--feature_path", out, "--weights", "random", "--batch_size", "32",
                "--compute_dtype", "bfloat16", "--data_parallel", "--device", dev.type,
                *fleet("features")]))
            secs = time.perf_counter() - t0
            dist.destroy_process_group()
            shapes = []
            for sid in ids:
                with h5py.File(os.path.join(out, "TCGA-FLT", sid, f"{sid}.h5"), "r") as f:
                    shapes.append(list(f["resnet_features"][:].shape))
            res["compute_features_multihost"] = {"slides": got["slides"], "shapes": shapes,
                                                 "seconds": secs, "store": source}
            if got["slides"] != len(ids) or shapes != [[PAR_FLEET_PATCHES, D]] * len(ids):
                raise AssertionError(f"parallel_fleet: compute_features --multihost wrote "
                                     f"{got['slides']} slides {shapes}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil_rmtree(tmp)
    return res


def parallel_path(torch, dev, folds=None) -> dict:
    """Phase 11; returns the kernels' launch counts of its data-parallel and
    fleet runs."""
    from sequoia_tpu_torch import _build

    t0 = time.perf_counter()
    if folds is None:
        _, folds = models(torch, dev)
    launches = {k: 0 for k in _build.LAUNCHES}
    train = par_train(torch, dev)
    emit({"phase": "parallel_train", **{k: v for k, v in train.items() if k != "gloo"}})
    emit({"phase": "parallel_gloo", **train["gloo"]})
    torch.cuda.empty_cache()
    emit({"phase": "parallel_dp", **par_dp(torch, dev, folds, launches)})
    torch.cuda.empty_cache()
    emit({"phase": "parallel_fleet", **par_fleet(torch, dev, folds, launches)})
    check_launched(launches, ("stem16", "bottleneck_chain_cp", "bottleneck_chain",
                              "lloyd_stats", "vis_blocks_fused"), "parallel path")
    emit({"phase": "parallel_launches", **launches,
          "phase_seconds": time.perf_counter() - t0})
    return launches




# ---------------------------------------------------------------------------
# phase 12: raw-plane serving ('ycbcr' and 'mosaic') through K4, K5 and K1
# ---------------------------------------------------------------------------

# (tile side, (sh, sv)) of each layout: patch-sized tiles at 4:2:0 and 4:2:2
# ('ycbcr'), and Aperio's 240-px tiles at 4:2:0 ('mosaic'; 8192 is no
# multiple of 240, so the last row and column of tiles are edge tiles)
RAW_LAYOUTS = ((PATCH, (2, 2)), (PATCH, (2, 1)), (240, (2, 2)))
# the raw modes against 'rgb' on the same reader: the prediction
# (tests/test_mosaic.py's rtol and atol; for the mosaic in bf16, where a
# patch's place in its batch moves its rounding (raw_position_probe),
# Pearson r: 1 - 7.2e-9 measured on an H100, so 1 - 1e-6 leaves a margin of
# about 140 and no more), the kept features (the same rows: max |diff| /
# max |rgb|, 6.9e-4 measured in bf16, 0 in f32)
RAW_RTOL, RAW_ATOL, RAW_BF16_R, RAW_FEAT_TOL = 2e-4, 1e-4, 1 - 1e-6, 1e-3


class PlanarSlide:
    """A stand-in for a slide file of JPEG tiles, never in the package: the
    tiled level 0 of an ``ArrayReader`` slide encoded once into per-tile
    planar Y ++ Cb ++ Cr (JFIF RGB -> YCbCr rounded, chroma averaged over
    ``sh x sv``, edge tiles padded by repeating the last row and column, as
    an encoder pads), on the card, held on the host.  It exposes the native
    reader's raw-plane interface: ``tile_dims``, ``ycbcr_subsampling`` (the
    subsampling only where ``size`` is the tile dims) and a strict
    ``read_regions_ycbcr`` (``OSError`` on an unaligned or wrong-sized
    request, and on ``fail_tile``, counted in ``failed_reads``).
    ``read_region(s)`` at level 0 are what
    libjpeg would decode: every tile rebuilt on the CPU by the port's
    ``ops/ycbcr.planar_to_rgb`` (which the CPU tests hold against libjpeg
    and against JAX), zero past the level's bounds; the card never runs
    libjpeg.  Other levels (the slide mask's) are the wrapped slide's."""

    def __init__(self, torch, dev, slide, tile: int, sub, fail_tile=None):
        self._slide, self.tile, self.sub, self.fail_tile = slide, tile, tuple(sub), fail_tile
        self.failed_reads = 0
        self.level_dimensions = slide.level_dimensions
        self.properties = {"aperio.AppMag": "20"}
        lv0 = torch.as_tensor(slide.levels[0], device=dev)
        h0, w0 = lv0.shape[:2]
        self.ntx, self.nty = -(-w0 // tile), -(-h0 // tile)
        rows = torch.arange(self.nty * tile, device=dev).clamp(max=h0 - 1)
        cols = torch.arange(self.ntx * tile, device=dev).clamp(max=w0 - 1)
        r, g, b = lv0[rows][:, cols].float().unbind(-1)
        sh, sv = self.sub

        def u8(p):
            return p.round().clamp(0, 255)

        def tiles(p, th, tw):  # (nty * th, ntx * tw) -> (nty, ntx, th * tw)
            return p.reshape(self.nty, th, self.ntx, tw).permute(0, 2, 1, 3).reshape(
                self.nty, self.ntx, th * tw)

        def chroma(p):  # the sh x sv block means of a rounded full-resolution plane
            p = u8(p)
            return tiles(u8(p.reshape(p.shape[0] // sv, sv, p.shape[1] // sh, sh).mean((1, 3))),
                         tile // sv, tile // sh)

        y = tiles(u8(0.299 * r + 0.587 * g + 0.114 * b), tile, tile)
        cb = chroma(-0.168736 * r - 0.331264 * g + 0.5 * b + 128)
        cr = chroma(0.5 * r - 0.418688 * g - 0.081312 * b + 128)
        self.planes = torch.cat([y, cb, cr], -1).to(torch.uint8).cpu().numpy()
        self._decoded = None

    def tile_dims(self, level: int):
        return (self.tile, self.tile) if level == 0 else None

    def ycbcr_subsampling(self, level: int, size):
        return self.sub if level == 0 and tuple(size) == self.tile_dims(0) else None

    def read_regions_ycbcr(self, locations, level, size, nthreads=None):
        import numpy as np

        if self.ycbcr_subsampling(level, size) is None:
            raise OSError("raw YCbCr path unsupported for this level/size")
        out = []
        for x, y in locations:
            tx, ty = x // self.tile, y // self.tile
            if (tx, ty) == self.fail_tile:
                self.failed_reads += 1
                raise OSError(f"read_regions_ycbcr: corrupt tile at ({x}, {y})")
            if x % self.tile or y % self.tile or not 0 <= tx < self.ntx or not 0 <= ty < self.nty:
                raise OSError(f"read_regions_ycbcr: no whole tile at ({x}, {y})")
            out.append(self.planes[ty, tx])
        return np.stack(out)

    def _level0(self):
        """Level 0 as the tiles decode, built on the first RGB read."""
        if self._decoded is None:
            import torch
            from sequoia_tpu_torch.data.wsi import ArrayReader
            from sequoia_tpu_torch.ops import ycbcr

            t, (w0, h0) = self.tile, self.level_dimensions[0]
            flat = torch.from_numpy(self.planes.reshape(self.nty * self.ntx, -1))
            rgb = torch.cat([ycbcr.planar_to_rgb(flat[s:s + 64], t, t, *self.sub)
                             for s in range(0, len(flat), 64)])
            lv0 = rgb.reshape(self.nty, self.ntx, t, t, 3).permute(0, 2, 1, 3, 4).reshape(
                self.nty * t, self.ntx * t, 3)[:h0, :w0].numpy()
            self._decoded = ArrayReader([lv0], properties=self.properties)
        return self._decoded

    def read_region(self, location, level, size):
        if level == 0:
            return self._level0().read_region(location, 0, size)
        return self._slide.read_region(location, level, size)

    def read_regions(self, locations, level, size, nthreads=None):
        import numpy as np

        return np.stack([self.read_region(loc, level, size) for loc in locations])


def raw_recon_check(torch, dev, slide) -> dict:
    """``planar_to_rgb`` + ``mask_to_valid`` on one batch of 128 candidates'
    planes at 256 px and 4:2:0 on the card, bit-equal to the CPU, and its ms
    against a bytes bound (planes read, RGB written: a floor, not a target,
    for unfused elementwise ops)."""
    import numpy as np
    from sequoia_tpu_torch.ops import ycbcr

    planes = slide.planes.reshape(-1, slide.planes.shape[-1])[:FEAT_BATCH]
    wh = np.full((len(planes), 2), PATCH, np.int32)
    wh[-3:] = ((PATCH, 17), (5, PATCH), (0, 0))  # edge and padding rows
    pc, whc = torch.from_numpy(planes), torch.from_numpy(wh)
    pd, whd = pc.to(dev), whc.to(dev)

    def recon(p, w):
        return ycbcr.mask_to_valid(ycbcr.planar_to_rgb(p, PATCH, PATCH, *slide.sub), w)

    equal = bool(torch.equal(recon(pd, whd).cpu(), recon(pc, whc)))
    if not equal:
        raise AssertionError("raw_recon: the card's reconstruction differs from the CPU's")
    ms = time_ms(torch, lambda: recon(pd, whd), 10)
    nbytes_ = planes.nbytes + len(planes) * PATCH * PATCH * 3
    bms, by = bound_ms(nbytes_, 0, "bfloat16")
    return {"batch": len(planes), "sub": list(slide.sub), "bit_equal_cpu": equal, "ms": ms,
            "bound_ms": bms, "bound_by": by, "bound_is": "a floor for unfused elementwise ops"}


def raw_assemble_check(torch, dev, pred, slide) -> dict:
    """One mosaic chunk's tile rebuild and one batch's patch gather on the
    card, bit-equal to the CPU, with their ms."""
    from sequoia_tpu_torch.ops import mosaic, ycbcr

    cands = pred._candidates(slide)
    layout = pred._mosaic_layout(slide, PATCH)
    stack, idx, offs, wh, _, (ky, kx) = next(pred._decode_mosaic_chunks(cands, layout))
    tw, th, sh, sv = layout
    b = [torch.from_numpy(a[:FEAT_BATCH]) for a in (idx, offs, wh)]
    bd = [a.to(dev) for a in b]
    sd = torch.from_numpy(stack).to(dev)

    def rebuild():
        return ycbcr.planar_to_rgb(sd, th, tw, sh, sv)

    tiles = rebuild()
    got = mosaic.gather_patches(tiles, *bd, PATCH, ky, kx)
    want = mosaic.make_assemble(PATCH, *layout, ky, kx)(torch.from_numpy(stack), *b)
    equal = bool(torch.equal(got.cpu(), want))
    if not equal:
        raise AssertionError("raw_assemble: the card's patches differ from the CPU's")
    return {"tiles_in_chunk": len(stack) - 1, "neighbourhood": [ky, kx],
            "batch": len(b[0]), "bit_equal_cpu": equal,
            "tiles_rebuild_ms": time_ms(torch, rebuild, 5),
            "gather_ms_per_batch": time_ms(torch, lambda: mosaic.gather_patches(
                tiles, *bd, PATCH, ky, kx), 5)}


def raw_position_probe(torch, pred, slide, dtype=None) -> dict:
    """Which layers of the backbone (bf16, or ``dtype``) move a row's
    rounding with its place in the batch.  On one batch of 128 candidates, each step of
    ``resnet.forward_extract`` (the stem, each stage's stride-2 transition
    block and its stride-1 chain, the pool) on the input the forward gives
    it, against the same input with its rows rotated by 1 and by 64 and
    restored: ``[max rel at 1, at 64]`` (max |diff| / max |out|), 0 where
    the step is blind to a row's place; ``whole`` is the backbone so.  Once
    with the chains through K4 (``fused_stages`` (1, 2, 3, 4), channels_last)
    and once through cuDNN (``fused_stages`` (), NCHW); the steps composed
    must equal ``forward_extract`` bit for bit."""
    import functools

    import torch.nn.functional as F
    from sequoia_tpu_torch.models import resnet

    dtype = dtype or torch.bfloat16
    params = pred.extractor.params
    cands = pred._candidates(slide)
    u8 = torch.as_tensor(next(pred._decode_chunks(cands, FEAT_BATCH)), device=pred.device)

    def moved(fn, x):
        a = fn(x)
        d = [float((a.float() - fn(x.roll(k, 0)).roll(-k, 0).float()).abs().max()
                   / a.float().abs().max()) for k in (1, 64)]
        return a, d

    def stem(x, layout):
        x = resnet.stem_space_to_depth(x, params["conv1_s2d"]).permute(0, 3, 1, 2)
        x = F.max_pool2d(torch.relu(resnet._bn(x, params["bn1"])), 3, 2, 1)
        return x.contiguous(memory_format=layout)

    out = {}
    for name, fused in (("k4", (1, 2, 3, 4)), ("cudnn", ())):
        cfg = resnet.ResNetConfig(compute_dtype=dtype, fused_stages=fused)
        layout = torch.channels_last if fused else torch.contiguous_format
        steps = {}
        x, steps["stem"] = moved(lambda v: stem(v, layout),
                                 resnet.preprocess_uint8(u8).to(dtype))
        for s in range(4):
            blocks = params[f"layer{s + 1}"]
            if s > 0:
                x, steps[f"layer{s + 1}_transition"] = moved(
                    lambda v: resnet._bottleneck(v, blocks[0], 2), x)
            start = int(s > 0)
            x, steps[f"layer{s + 1}_chain"] = moved(
                (lambda v: resnet._fused_chain(v, blocks, start)) if fused else
                (lambda v: functools.reduce(lambda a, p: resnet._bottleneck(a, p, 1),
                                            blocks[start:], v)), x)
        x, steps["pool"] = moved(
            lambda v: F.avg_pool2d(v.float(), 7, stride=cfg.pool_stride).reshape(len(v), -1)
            if min(v.shape[2:]) >= 7 else v.float().mean((2, 3)), x)
        whole, steps["whole"] = moved(lambda v: resnet.extract_from_uint8(cfg, params, v), u8)
        if not torch.equal(x, whole):
            raise AssertionError(f"raw_position_probe {name}: steps differ from the forward")
        out[name] = steps
    return out


def raw_planes_path(torch, dev, rparams=None, folds=None) -> dict:
    """Phase 12; returns the kernels' launch counts of its runs."""
    import copy

    import numpy as np
    from sequoia_tpu_torch import _build
    from sequoia_tpu_torch.models import resnet
    from sequoia_tpu_torch.pipeline.features import FeatureExtractor
    from sequoia_tpu_torch.serve import SlidePredictor

    t0 = time.perf_counter()
    if folds is None:
        rparams, folds = models(torch, dev)

    def predictor(dtype):
        rcfg = resnet.ResNetConfig(compute_dtype=dtype, fused_stages=(1, 2, 3, 4))
        ext = FeatureExtractor("resnet", rparams, batch_size=FEAT_BATCH, cfg=rcfg,
                               patch_size=PATCH, device=dev)
        return SlidePredictor(ext, folds, n_clusters=K, use_pallas_kmeans=True,
                              use_fused_vis=True, patch_size=PATCH, device=dev)

    pred = predictor(torch.bfloat16)
    base = [make_slide(torch, dev, s) for s in (1, 2)]

    def serve(p, slide, force_rgb=False) -> dict:
        """One slide in its best mode or in 'rgb': seconds, io_stats deltas,
        launches, the prediction and the kept features."""
        seen, orig = [], p.predict_features
        p.predict_features = lambda f: seen.append(f) or orig(f)
        before, l0 = dict(p.io_stats), dict(_build.LAUNCHES)
        t1 = time.perf_counter()
        try:
            y = p._consume_retrying(slide, p._start_producer(slide, force_rgb=force_rgb))
            torch.cuda.synchronize()
        finally:
            del p.predict_features
        return {"seconds": time.perf_counter() - t1, "y": y, "feats": seen[0],
                "stats": {k: p.io_stats[k] - before[k] for k in before},
                "launches": {k: _build.LAUNCHES[k] - l0[k] for k in l0}}

    def agree(raw, rgb) -> dict:
        """The kept set (the same rows: features within RAW_FEAT_TOL of the
        largest) and the prediction's max |diff| and r against 'rgb'."""
        fa, fb = raw["feats"], rgb["feats"]
        same = fa.shape == fb.shape and raw["stats"]["kept"] == rgb["stats"]["kept"]
        frel = float((fa - fb).abs().max() / fb.abs().max()) if same else None
        return {"kept_set_equal_rgb": same and frel <= RAW_FEAT_TOL,
                "kept_features_max_rel_diff": frel,
                "max_abs_diff_vs_rgb": float(np.abs(raw["y"] - rgb["y"]).max()),
                "pearson_r_vs_rgb": pearson(np, raw["y"], rgb["y"]),
                "within_tol": bool(np.allclose(raw["y"], rgb["y"], rtol=RAW_RTOL,
                                               atol=RAW_ATOL))}

    def close(mode, y, y_rgb) -> bool:
        """A bf16 raw prediction against 'rgb''s: within the tolerance for
        'ycbcr' (the same batches), r >= RAW_BF16_R for the mosaic."""
        if mode == "ycbcr":
            return bool(np.allclose(y, y_rgb, rtol=RAW_RTOL, atol=RAW_ATOL))
        return pearson(np, y, y_rgb) >= RAW_BF16_R

    _build.reset_launches()
    for tile, sub in RAW_LAYOUTS:
        t1 = time.perf_counter()
        slides = [PlanarSlide(torch, dev, s, tile, sub) for s in base]
        setup_s = time.perf_counter() - t1
        mode = pred._pick_mode(pred._candidates(slides[0]), False)[0]
        want_mode = "ycbcr" if tile == PATCH else "mosaic"
        if mode != want_mode:
            raise AssertionError(f"raw planes {tile}@{sub}: mode {mode}, not {want_mode}")
        serve(pred, slides[0])  # warm-ups: the mode's first batch, then 'rgb''s
        serve(pred, slides[0], force_rgb=True)
        raw, rgb = serve(pred, slides[0]), serve(pred, slides[0], force_rgb=True)
        rgb2 = serve(pred, slides[1], force_rgb=True)["y"]
        l0 = dict(_build.LAUNCHES)
        t1 = time.perf_counter()
        both = list(pred.predict_slides(slides))
        torch.cuda.synchronize()
        slides_s = time.perf_counter() - t1
        lc = {k: raw["launches"][k] + _build.LAUNCHES[k] - l0[k] for k in l0}
        check_launched(lc, ("bottleneck_chain", "lloyd_stats", "vis_blocks_fused"),
                       f"raw planes {mode}")
        y = raw["y"]
        if y.shape != (1, GENES) or not np.isfinite(y).all():
            raise AssertionError(f"raw planes {mode}: prediction {y.shape} not finite (1, G)")
        ag = agree(raw, rgb)
        d_slides = float(np.abs(both[0][1] - y).max())
        d_slide2 = float(np.abs(both[1][1] - rgb2).max())
        ratio = raw["stats"]["bytes_uploaded"] / rgb["stats"]["bytes_uploaded"]
        line = {"phase": "raw_planes", "tile": tile, "sub": list(sub), "mode": mode,
                "dtype": "bfloat16", "setup_s": setup_s,
                "candidates": raw["stats"]["candidates"], "kept": raw["stats"]["kept"],
                "kept_rgb": rgb["stats"]["kept"],
                "bytes_per_slide": raw["stats"]["bytes_uploaded"],
                "rgb_bytes_per_slide": rgb["stats"]["bytes_uploaded"], "bytes_ratio": ratio,
                "seconds": raw["seconds"], "rgb_seconds": rgb["seconds"],
                "predict_slides_seconds_per_slide": slides_s / len(slides),
                "launches": lc, **ag, "max_abs_diff_predict_slides_vs_wsi": d_slides,
                "slide2_max_abs_diff_vs_rgb": d_slide2,
                "slide2_pearson_r_vs_rgb": pearson(np, both[1][1], rgb2)}
        if mode == "mosaic":
            # the mosaic batches candidates in spatial order, so a kept patch
            # sits elsewhere in its batch than in 'rgb'; in bf16 that moves
            # its features by rounding (the probe), and k-means and the folds
            # carry it to the prediction.  f32 holds the tolerance.
            line["bf16_batch_position"] = raw_position_probe(torch, pred, slides[0])
            p32 = predictor(torch.float32)
            r32, g32 = serve(p32, slides[0]), serve(p32, slides[0], force_rgb=True)
            # the f32 backbone, its chains through the 3xTF32 K4: K4 must be
            # blind to a row's place (each output row one fixed-order K sum)
            probe32 = raw_position_probe(torch, p32, slides[0], torch.float32)
            moved_k4 = {k: v for k, v in probe32["k4"].items()
                        if k.endswith("_chain") and any(v)}
            line["float32"] = {"seconds": r32["seconds"], "rgb_seconds": g32["seconds"],
                               "launches": r32["launches"], **agree(r32, g32),
                               "batch_position": probe32}
            del p32
            if moved_k4:
                raise AssertionError(f"raw planes f32: K4's chains move with a row's place "
                                     f"in the batch: {moved_k4}")
        emit(line)
        if not ag["kept_set_equal_rgb"]:
            raise AssertionError(f"raw planes {mode}: kept set differs from 'rgb'")
        # the mosaic is also held in f32, to the tolerance and the kept set
        held = close(mode, y, rgb["y"]) and (mode == "ycbcr" or (
            line["float32"]["within_tol"] and line["float32"]["kept_set_equal_rgb"]))
        if not held or not np.allclose(both[0][1], y, rtol=RAW_RTOL, atol=RAW_ATOL):
            raise AssertionError(f"raw planes {mode}: prediction differs from 'rgb' {line}")
        if not np.isfinite(both[1][1]).all() or not close(mode, both[1][1], rgb2):
            raise AssertionError(f"raw planes {mode}: predict_slides slide 2 differs from 'rgb'")
        if mode == "ycbcr" and sub == (2, 2) and ratio > 0.55:
            raise AssertionError(f"raw planes ycbcr 4:2:0: {ratio:.3f} of 'rgb''s bytes")
        if tile == PATCH and sub == (2, 2):
            emit({"phase": "raw_recon", **raw_recon_check(torch, dev, slides[0])})
            # a strict raw read that fails on one tissue tile: served in 'rgb'
            bad = copy.copy(slides[0])  # the same planes and decoded level 0
            bad.fail_tile = (slides[0].ntx // 2, slides[0].nty // 2)
            retry = serve(pred, bad)
            r_diff = float(np.abs(retry["y"] - rgb["y"]).max())
            emit({"phase": "raw_retry", "tile": tile, "sub": list(sub),
                  "fail_tile": list(bad.fail_tile), "failed_reads": bad.failed_reads,
                  "seconds": retry["seconds"], "max_abs_diff_vs_rgb": r_diff})
            # a raw read failed, so the prediction can only be the retry's
            if bad.failed_reads < 1:
                raise AssertionError("raw_retry: the failing tile was never read")
            if not np.allclose(retry["y"], rgb["y"], rtol=RAW_RTOL, atol=RAW_ATOL):
                raise AssertionError(f"raw_retry: differs from 'rgb' ({r_diff})")
        if mode == "mosaic":
            emit({"phase": "raw_assemble", **raw_assemble_check(torch, dev, pred, slides[0])})
        del slides
    launches = dict(_build.LAUNCHES)
    emit({"phase": "raw_planes_launches", **launches,
          "phase_seconds": time.perf_counter() - t0})
    return launches


# ---------------------------------------------------------------------------
# phase 13: the tool layer (sequoia_tpu_torch/tools) on the card
# ---------------------------------------------------------------------------

# the settings profile_backbone times (ResNetConfig options), each held
# against the plain setting's features at STAGE_FEAT_TOL; the stage rows must
# sum to within STAGE_SUM_TOL of the whole forward
TOOL_SETTINGS = (("plain", {}), ("early_pallas", {"early_pallas": True}),
                 ("early_pallas+cp", {"early_pallas": True, "cp": (2, 3, 4)}),
                 ("fused", {"fused": (1, 2, 3, 4)}))
TOOL_ITERS, STAGE_SUM_TOL = 10, 0.15
# the fabricated hub's UNI: ViT-L/16 width (1024, 16 heads, MLP 4096, 224 px),
# depth cut from 24 to 2 (the oracle runs in float64)
TOOL_UNI_DEPTH = 2


def tools_backbone(torch, dev) -> list:
    """``profile_backbone`` at batch 128 in bf16 and f32 under each of
    TOOL_SETTINGS, its features against the plain setting's."""
    from sequoia_tpu_torch.models import resnet
    from sequoia_tpu_torch.tools import profile_backbone as pb

    g = torch.Generator(device=dev).manual_seed(13)
    params = resnet.random_params(g)
    u8 = torch.randint(0, 256, (FEAT_BATCH, PATCH, PATCH, 3), generator=g, device=dev,
                       dtype=torch.uint8)
    rows = []
    for dtype in ("bfloat16", "float32"):
        plain = None
        for name, opts in TOOL_SETTINGS:
            t0 = time.perf_counter()
            cfg = pb.make_config(dtype, **opts)
            feats = resnet.extract_from_uint8(cfg, params, u8)
            plain = feats if plain is None else plain
            rel = float((feats - plain).abs().max() / plain.abs().max())
            res = pb.profile(cfg, params, u8, TOOL_ITERS, dev)
            row = {"dtype": dtype, "setting": name, "batch": FEAT_BATCH,
                   "features_max_rel_diff_vs_plain": rel, "features_tol": STAGE_FEAT_TOL[dtype],
                   **res, "seconds": time.perf_counter() - t0}
            emit({"phase": "tools_profile_backbone", **row})
            if not bool(torch.isfinite(feats).all()) or rel > STAGE_FEAT_TOL[dtype]:
                raise AssertionError(f"profile_backbone {dtype} {name}: features {rel:.3g} "
                                     f"from plain > {STAGE_FEAT_TOL[dtype]:g}")
            if abs(res["stages_sum_over_forward"] - 1) > STAGE_SUM_TOL:
                raise AssertionError(f"profile_backbone {dtype} {name}: stage rows sum to "
                                     f"{res['stages_sum_ms']:.3f} ms of a "
                                     f"{res['forward_ms']:.3f} ms forward")
            rows.append(row)
            del feats
    return rows


def tools_train_step(torch, dev) -> dict:
    """``profile_train_step`` at the production shape (B 16, T 100, D 2048,
    G 20,820), every value finite."""
    from sequoia_tpu_torch.tools import profile_train_step as pts

    t0 = time.perf_counter()
    res = {"vis": pts.profile_vis(device=dev)}
    torch.cuda.empty_cache()
    res["he2rna"] = pts.profile_he2rna(device=dev)
    torch.cuda.empty_cache()
    flat = [v for part in res.values() for v in part.values() if not isinstance(v, dict)]
    flat += [v for part in res.values() for d in part.values() if isinstance(d, dict)
             for v in d.values()]
    if not all(isinstance(v, (int, float)) and v == v and abs(v) != float("inf") for v in flat):
        raise AssertionError(f"profile_train_step: a value is not finite: {res}")
    res["seconds"] = time.perf_counter() - t0
    return res


def calibrated_resnet50_sd(torch, dev, seed: int) -> dict:
    """``goldens.resnet50_sd`` (f32, on the CPU) with every BN's running mean
    and variance set to the statistics of its input over a seeded batch of
    16 patches, as a trained network's are: the activations keep their scale
    through the 16 blocks (features of order 1, as torchvision's), where the
    uncalibrated state dict grows them to thousands (``tools_uncalibrated``)."""
    import torch.nn.functional as F

    from sequoia_tpu_torch.models import resnet
    from sequoia_tpu_torch.tools import goldens

    sd = {k: v.to(dev) for k, v in goldens.resnet50_sd(torch.Generator().manual_seed(seed))
          .items()}
    g = torch.Generator(device=dev).manual_seed(seed)
    u8 = torch.randint(0, 256, (16, PATCH, PATCH, 3), generator=g, device=dev,
                       dtype=torch.uint8)

    def conv_bn(x, conv, bn, **kw):
        y = F.conv2d(x, sd[conv + ".weight"], **kw)
        sd[bn + ".running_mean"] = y.mean((0, 2, 3))
        sd[bn + ".running_var"] = y.var((0, 2, 3), unbiased=False)
        return F.batch_norm(y, sd[bn + ".running_mean"], sd[bn + ".running_var"],
                            sd[bn + ".weight"], sd[bn + ".bias"], training=False, eps=1e-5)

    x = resnet.preprocess_uint8(u8).double().permute(0, 3, 1, 2)
    x = F.max_pool2d(F.relu(conv_bn(x, "conv1", "bn1", stride=2, padding=3)), 3, 2, 1)
    for s, nblocks in enumerate(goldens.RESNET_BLOCKS):
        for b in range(nblocks):
            pre, stride = f"layer{s + 1}.{b}.", 2 if (b == 0 and s > 0) else 1
            y = F.relu(conv_bn(x, pre + "conv1", pre + "bn1"))
            y = F.relu(conv_bn(y, pre + "conv2", pre + "bn2", stride=stride, padding=1))
            y = conv_bn(y, pre + "conv3", pre + "bn3")
            if pre + "downsample.0.weight" in sd:
                x = conv_bn(x, pre + "downsample.0", pre + "downsample.1", stride=stride)
            x = F.relu(y + x)
    return {k: v.float().cpu() for k, v in sd.items()}


def tools_uncalibrated(torch, dev) -> dict:
    """The ResNet-50 routes of ``validate_real_weights`` on the JAX tests'
    uncalibrated ``resnet50_sd`` (its features grow to thousands): each
    route's largest |delta| to the float64 oracle relative to the oracle's
    largest feature, held to the kernels' f32 tolerance against their plain
    versions (``TOL``); the JAX tool's absolute bound of 1e-2 is a relative
    2e-6 there, tighter than f32 rounding carried through 16 blocks."""
    import numpy as np

    from sequoia_tpu_torch.tools import goldens
    from sequoia_tpu_torch.tools import validate_real_weights as vrw

    sd = {k: v.float().numpy() for k, v in goldens.resnet50_sd(
        torch.Generator().manual_seed(133)).items()}
    u8 = np.random.default_rng(0).integers(0, 256, (2, PATCH, PATCH, 3), dtype=np.uint8)
    outs, _ = vrw.resnet50_forwards(sd, u8, dev)
    oracle = outs.pop("oracle")
    scale = float(np.abs(oracle).max())
    tol = TOL["bottleneck_chain"]["float32"]
    rows = {route: {"max_abs": float(np.abs(y - oracle).max()),
                    "max_abs_over_max_feature": float(np.abs(y - oracle).max()) / scale,
                    "passes_jax_bound": float(np.abs(y - oracle).max()) <= vrw.MAX_ABS}
            for route, y in outs.items()}
    if any(r["max_abs_over_max_feature"] > tol for r in rows.values()):
        raise AssertionError(f"uncalibrated resnet50: a route past {tol:g} of the largest "
                             f"feature: {rows}")
    return {"oracle_max_feature": scale, "tol": tol, "rows": rows}


def tools_hub(torch, dev, root: str) -> float:
    """A local hub of seeded random weights in the released layouts: a ViS
    fold at full width in the HF layout (config.json + pytorch_model.bin),
    the ViT (dim and MLP 2048, depth SERVE_VIT_DEPTH) and HE2RNA (2048 -> 256
    -> 256 -> 20,820) fixtures, torchvision's resnet50.pth (BN statistics
    calibrated: :func:`calibrated_resnet50_sd`) and UNI's
    uni/pytorch_model.bin (depth TOOL_UNI_DEPTH); returns its seconds."""
    from sequoia_tpu_torch.models import convert, he2rna, vis
    from sequoia_tpu_torch.tools import goldens
    from sequoia_tpu_torch.train import checkpoint, cv

    t0 = time.perf_counter()
    vcfg = vis.ViSConfig(num_outputs=GENES, input_dim=D, depth=6, nheads=16, dim_f=64,
                         dim_s=64, dim_c=64, num_clusters=K)
    fold = os.path.join(root, "sequoia-syn-0")
    checkpoint.save_torch_state_dict(
        convert.vis_to_torch(vcfg, vis.init(vcfg, torch.Generator(device=dev).manual_seed(130))),
        os.path.join(fold, "pytorch_model.bin"))
    with open(os.path.join(fold, "config.json"), "w") as f:
        json.dump({"num_outputs": GENES, "input_dim": D}, f)
    cfg, params, _, to_torch, _ = cv.build_model(
        "vit", GENES, D, torch.Generator(device=dev).manual_seed(131), depth=SERVE_VIT_DEPTH,
        num_clusters=K)
    checkpoint.save_torch_state_dict(to_torch(cfg, params), os.path.join(root, "vit-test.pt"))
    hcfg = he2rna.HE2RNAConfig(input_dim=D, output_dim=GENES, layers=HE_LAYERS,
                               ks=he2rna.ks_for_tokens(K))
    checkpoint.save_torch_state_dict(
        convert.he2rna_to_torch(hcfg, he2rna.init(hcfg, torch.Generator(device=dev)
                                                  .manual_seed(132))),
        os.path.join(root, "he2rna-test.pt"))
    torch.save(calibrated_resnet50_sd(torch, dev, 133), os.path.join(root, "resnet50.pth"))
    os.makedirs(os.path.join(root, "uni"))
    torch.save({k: v.float() for k, v in goldens.uni_sd(
        torch.Generator().manual_seed(134), img=224, patch=16, dim=UNI_DIM,
        depth=TOOL_UNI_DEPTH, heads=16, mlp=4 * UNI_DIM).items()},
        os.path.join(root, "uni", "pytorch_model.bin"))
    return time.perf_counter() - t0


def tools_validate(torch, dev, root: str) -> dict:
    """``validate_real_weights`` on the card over the hub of :func:`tools_hub`
    (the ViS fold through K1, the ResNet-50 extractor through K2 + K3 and
    through K4, every artifact's plain forward, each against the float64
    oracle); any row out of the bound, or an exit code other than 0, fails."""
    import io

    from sequoia_tpu_torch.tools import validate_real_weights as vrw

    hub = os.path.join(root, "hub")
    seconds = tools_hub(torch, dev, hub)
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = vrw.main(["--cancers", "syn", "--folds", "0", "--local-hub", hub,
                       "--notes", os.path.join(root, "PARITY_NOTES_TORCH.md")])
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    want = {"gevaertlab/sequoia-syn-0 [plain]", "gevaertlab/sequoia-syn-0 [K1 vis_blocks_fused]",
            "torchvision/resnet50-IMAGENET1K_V1 [plain]",
            "torchvision/resnet50-IMAGENET1K_V1 [K2+K3 early_pallas]",
            "torchvision/resnet50-IMAGENET1K_V1 [K4 fused_stages]", "MahmoodLab/UNI [plain]",
            "local/vit-test.pt [plain]", "local/he2rna-test.pt [plain]"}
    bad = {k: r for k, r in res["rows"].items() if not r["pass"]}
    if rc != 0 or bad or set(res["rows"]) != want or res["pending"]:
        raise AssertionError(f"validate_real_weights: rc {rc}, failing rows {bad}, rows "
                             f"{sorted(res['rows'])}, pending {res['pending']}")
    return {**res, "hub_seconds": seconds, "seconds": time.perf_counter() - t0}


def tools_host(torch, root: str) -> dict:
    """``make_example_data --wsis`` (no feature store: no h5py here), its
    TIFFs read back, and ``parity_check`` on a pair of pickles that passes and
    one that fails."""
    import io
    import pickle

    import numpy as np

    from sequoia_tpu_torch import native
    from sequoia_tpu_torch.tools import make_example_data as med
    from sequoia_tpu_torch.tools import parity_check

    t0 = time.perf_counter()
    out = os.path.join(root, "examples")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        med.main(["--out", out, "--n_slides", "2", "--n_genes", "50", "--wsis"])
    tiffs = sorted(os.listdir(os.path.join(out, "HE")))
    from PIL import Image

    for i, name in enumerate(tiffs):
        with Image.open(os.path.join(out, "HE", name)) as im:
            levels = []
            for j in range(im.n_frames):
                im.seek(j)
                levels.append(np.asarray(im.convert("RGB")))
        want = med.synthetic_levels(seed=i)
        if len(levels) != 2 or not all(np.array_equal(a, b) for a, b in zip(levels, want)):
            raise AssertionError(f"make_example_data: {name} differs from its levels")
    example = {"files": sorted(os.listdir(out)), "tiffs": tiffs,
               "writer": "native" if native.available() else "Pillow",
               "report": buf.getvalue().strip(), "seconds": time.perf_counter() - t0}
    if len(tiffs) != 2 or not {"ref_file.csv", "gene_list.csv"} <= set(example["files"]):
        raise AssertionError(f"make_example_data: wrote {example}")

    rng = np.random.default_rng(13)
    genes = [f"G{i}" for i in range(GENES)]
    real = rng.normal(size=(40, GENES)).astype(np.float32)
    pred = real + rng.normal(size=real.shape).astype(np.float32)
    wsis = np.asarray([f"w{i:03d}" for i in range(40)])
    for name, p, order in (("ref", pred, np.arange(40)),
                           ("same", pred, rng.permutation(40)),
                           ("bad", pred + 2 * rng.normal(size=pred.shape).astype(np.float32),
                            np.arange(40))):
        halves = np.array_split(order, 2)
        res = {"genes": genes, **{f"split_{i}": {"real": real[h], "preds": p[h],
                                                 "wsi_file_name": wsis[h]}
                                  for i, h in enumerate(halves)}}
        with open(os.path.join(root, f"{name}.pkl"), "wb") as f:
            pickle.dump(res, f)
    parity = {}
    for name, want_rc in (("same", 0), ("bad", 1)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = parity_check.main(["--ref", os.path.join(root, "ref.pkl"),
                                    "--ours", os.path.join(root, f"{name}.pkl")])
        parity[name] = {"rc": rc, "report": buf.getvalue().strip().splitlines()}
        if rc != want_rc:
            raise AssertionError(f"parity_check {name}: rc {rc}, not {want_rc}")
    return {"make_example_data": example, "parity_check": parity}


def tools_path(torch, dev) -> dict:
    """Phase 13; returns the kernels' launch counts of the tools' runs."""
    import shutil
    import tempfile

    from sequoia_tpu_torch import _build

    t0 = time.perf_counter()
    _build.reset_launches()
    tools_backbone(torch, dev)
    torch.cuda.empty_cache()
    emit({"phase": "tools_profile_train_step", **tools_train_step(torch, dev)})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    try:
        emit({"phase": "tools_validate_real_weights", **tools_validate(torch, dev, tmp)})
        emit({"phase": "tools_uncalibrated_resnet50", **tools_uncalibrated(torch, dev)})
        torch.cuda.empty_cache()
        emit({"phase": "tools_host", **tools_host(torch, tmp)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dict(_build.LAUNCHES)
    check_launched(launches, ("stem16", "bottleneck_chain_cp", "bottleneck_chain",
                              "vis_blocks_fused"), "tools path")
    emit({"phase": "tools_launches", **launches, "phase_seconds": time.perf_counter() - t0})
    return launches


def km_steps(torch, dev, feats, pred) -> int:
    """The Lloyd steps of the fit ``pred.cluster`` ran on ``feats``."""
    from sequoia_tpu_torch.ops import kmeans as km

    mask = torch.ones((feats.shape[0],), dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev).manual_seed(pred.kmeans_seed)
    return km.kmeans_fit(feats.float(), mask, gen, K, use_pallas=pred.use_pallas)[3]


def r_min_check(r: float, floor: float) -> float:
    if r < floor:
        raise AssertionError(f"serve_cli: Pearson r {r} < {floor}")
    return r


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="", help="comma-separated kernel names (phases 1-3 "
                    "for these alone) and/or uni_path (phase 7), train_path (phase 8), "
                    "aggregators_path (phase 9), stages_path (phase 10), parallel_path "
                    "(phase 11), raw_planes_path (phase 12), tools_path (phase 13); prints "
                    "no result line")
    only = [k for k in ap.parse_args().only.split(",") if k]

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sequoia_tpu_torch import _build
    from sequoia_tpu_torch.ops.nn import precision

    precision()  # TF32 off: f32 means IEEE f32 for the plain versions too
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(_build.build().relative_to(_build.BUILD_DIR.parent.parent))})

    results = {}
    checks = (("stem16", check_stem16),
              ("bottleneck_chain_cp", functools.partial(check_chain, kname="bottleneck_chain_cp")),
              ("bottleneck_chain", functools.partial(check_chain, kname="bottleneck_chain")),
              ("vis_blocks_fused", check_vis))
    known = [k for k, _ in checks] + ["lloyd_stats", "uni_path", "train_path",
                                      "aggregators_path", "stages_path", "parallel_path",
                                      "raw_planes_path", "tools_path"]
    unknown = set(only) - set(known)
    if unknown:
        raise SystemExit(f"chip_smoke: --only takes {known}, got {unknown}")
    by_dtype: dict = {"float32": {}, "bfloat16": {}}
    for dtype in ("float32", "bfloat16"):
        for kname, fn in checks:
            if only and kname not in only:
                continue
            r = fn(torch, dev, dtype)
            emit({"phase": "kernel", "name": kname, "dtype": dtype, **r})
            by_dtype[dtype][kname] = r
            results[kname] = r  # the bf16 row (the main path's type) is kept
    totals = {dtype: chain_totals(rows) for dtype, rows in by_dtype.items()}
    for dtype, rows in by_dtype.items():
        if "bottleneck_chain" in rows or "bottleneck_chain_cp" in rows:
            emit({"phase": "chain_totals", "dtype": dtype, "per": "extractor batch",
                  **totals[dtype]})
    if not only or "lloyd_stats" in only:
        from sequoia_tpu_torch.ops import kmeans as km

        r = check_lloyd(torch, dev)
        emit({"phase": "kernel", "name": "lloyd_stats", "dtype": "float32", **r})
        results["lloyd_stats"] = r
        x, mask, init = near_tie_features(torch, dev)
        emit({"phase": "kmeans_near_tie", **kmeans_near_tie(torch, km, x, mask, init)})
        emit({"phase": "lloyd_step", "points": PATCHES, "dim": D, "k": K,
              **lloyd_step_profile(torch, km, x, mask, init)})
        del x, mask, init
    if only:
        if "uni_path" in only:
            emit({"phase": "uni_launches", **uni_path(torch, dev, [None, None])})
        if "train_path" in only:
            train_path(torch, dev)
        if "aggregators_path" in only:
            aggregators_path(torch, dev)
        if "stages_path" in only:
            stages_path(torch, dev, [None, None])
        if "parallel_path" in only:
            parallel_path(torch, dev)
        if "raw_planes_path" in only:
            raw_planes_path(torch, dev)
        if "tools_path" in only:
            tools_path(torch, dev)
        print(smi, flush=True)
        return 0
    emit({"phase": "chain_weight_fold", "dtype": "bfloat16", "per": "extractor batch",
          **time_weight_folds(torch, dev)})
    for dtype in ("bfloat16", "float32"):
        emit({"phase": "extractor_cp_stages", **check_cp_stages(torch, dev, dtype)})
    torch.cuda.empty_cache()

    rparams, folds = models(torch, dev)
    main, main_slide = main_path(torch, dev, rparams, folds)
    torch.cuda.empty_cache()
    main32, main32_slide = main_path_f32(torch, dev, rparams, folds)
    torch.cuda.empty_cache()
    wsi, kept, wsi_slide = wsi_path(torch, dev, rparams, folds)
    torch.cuda.empty_cache()
    served = serve_cli_path(torch, dev, folds)
    torch.cuda.empty_cache()
    raw = raw_planes_path(torch, dev, rparams, folds)
    del rparams, folds
    torch.cuda.empty_cache()
    uni = uni_path(torch, dev, kept)
    torch.cuda.empty_cache()
    keep = {}
    trained = train_path(torch, dev, keep)
    if any(trained.values()):
        raise AssertionError(f"the training path launched a TPU kernel's port: {trained}")
    torch.cuda.empty_cache()
    agg = aggregators_path(torch, dev)
    torch.cuda.empty_cache()
    stages = stages_path(torch, dev, kept, keep.pop("test_results"))
    torch.cuda.empty_cache()
    par = parallel_path(torch, dev)
    torch.cuda.empty_cache()
    tools = tools_path(torch, dev)
    launches = {k: main[k] + main32[k] + wsi[k] + served[k] + raw[k] + uni[k] + agg[k]
                + stages[k] + par[k] + tools[k] for k in results}

    rows = {dt: {**r, "lloyd_stats": results["lloyd_stats"]} for dt, r in by_dtype.items()}
    emit({"phase": "slide_cost", "per": "slide",
          "from_patches": slide_costs(rows["bfloat16"], totals["bfloat16"], main_slide),
          "from_patches_f32": slide_costs(rows["float32"], totals["float32"], main32_slide),
          "wsi": slide_costs(rows["bfloat16"], totals["bfloat16"], wsi_slide)})
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k][0], "replaces": SOURCES[k][1],
         "launches": launches[k], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]} for k, r in results.items()]})
    emit({"phase": "run_time", "seconds": time.perf_counter() - START})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
