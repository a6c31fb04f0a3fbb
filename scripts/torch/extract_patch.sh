#!/bin/bash
# The PyTorch/CUDA port's counterpart of scripts/extract_patch.sh: the same command
# lines through sequoia_tpu_torch.cli, which run on CUDA.
# Tile WSIs into patches HDF5 (reference scripts/extract_patch.sh equivalent)
python3 -m sequoia_tpu_torch.cli.patch_gen \
    --ref_file examples/ref_file.csv \
    --wsi_path examples/HE \
    --patch_path examples/Patches_hdf5 \
    --mask_path examples/Patches_hdf5 \
    --patch_size 256 \
    --max_patches_per_slide 4000
