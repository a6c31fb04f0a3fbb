#!/bin/bash
# The PyTorch/CUDA port's counterpart of scripts/run_he2rna.sh: the same command
# lines through sequoia_tpu_torch.cli, which run on CUDA.
# HE2RNA MLP aggregation baseline (reference scripts/run_he2rna.sh)
python3 -m sequoia_tpu_torch.cli.he2rna \
    --path_csv examples/ref_file.csv \
    --feature_path examples/features \
    --exp_name exp_he2rna \
    --batch_size 16 --k 5 --lr 1e-3
