#!/bin/bash
# The PyTorch/CUDA port's counterpart of scripts/run_visualize.sh: the same command
# lines through sequoia_tpu_torch.cli, which run on CUDA.
# Spatial expression maps (reference scripts/run_visualize.sh, fixed path)
python3 -m sequoia_tpu_torch.cli.visualize \
    --study gbm \
    --project spatial_GBM_pred \
    --gene_names all \
    --wsi_file_name HRI_1_T.tif \
    --save_folder vis_out \
    --model_type vis \
    --feat_type resnet \
    --weights "${RESNET50_WEIGHTS:-random}"
