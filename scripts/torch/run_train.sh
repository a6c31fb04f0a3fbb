#!/bin/bash
# The PyTorch/CUDA port's counterpart of scripts/run_train.sh: the same command
# lines through sequoia_tpu_torch.cli, which run on CUDA.
# 5-fold CV training of the ViS aggregator (reference scripts/run_train.sh)
python3 -m sequoia_tpu_torch.cli.main \
    --ref_file examples/ref_file.csv \
    --feature_path examples/features \
    --model_type vis \
    --depth 6 --num-heads 16 \
    --batch_size 16 --k 5 \
    --save_on loss+corr --stop_on loss+corr \
    --train \
    --exp_name exp_vis
