#!/bin/bash
# The PyTorch/CUDA port's counterpart of scripts/run_pretrain.sh: the same command
# lines through sequoia_tpu_torch.cli, which run on CUDA.
# GTEx pretraining (reference src/pretrain_gtex.py entry point)
python3 -m sequoia_tpu_torch.cli.pretrain_gtex \
    --path_csv examples/gtex_ref_file.csv \
    --feature_path examples/features \
    --model vis --num_epochs 200 --batch_size 16
