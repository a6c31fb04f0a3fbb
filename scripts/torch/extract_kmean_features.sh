#!/bin/bash
# The PyTorch/CUDA port's counterpart of scripts/extract_kmean_features.sh: the same command
# lines through sequoia_tpu_torch.cli, which run on CUDA.
# Per-slide 100-cluster k-means (reference scripts/extract_kmean_features.sh)
python3 -m sequoia_tpu_torch.cli.kmean_features \
    --ref_file examples/ref_file.csv \
    --patch_data_path examples/Patches_hdf5 \
    --feature_path examples/features \
    --num_clusters 100
