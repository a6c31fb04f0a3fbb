#!/bin/bash
# The PyTorch/CUDA port's counterpart of scripts/extract_resnet_features.sh: the same command
# lines through sequoia_tpu_torch.cli, which run on CUDA.
# ResNet-50 feature extraction (reference scripts/extract_resnet_features.sh)
# --weights: path to a torchvision resnet50 ImageNet state dict (.pth)
python3 -m sequoia_tpu_torch.cli.compute_features \
    --feat_type resnet \
    --ref_file examples/ref_file.csv \
    --patch_data_path examples/Patches_hdf5 \
    --feature_path examples/features \
    --weights "${RESNET50_WEIGHTS:-random}" \
    --batch_size 256
