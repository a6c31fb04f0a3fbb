#!/bin/bash
# The PyTorch/CUDA port's counterpart of scripts/run_evaluate.sh: the same command
# lines through sequoia_tpu_torch.cli, which run on CUDA.
# Per-gene significance tables from test_results.pkl files
# (reference evaluation/evaluate_model.py entry point)
python3 -m sequoia_tpu_torch.cli.evaluate_model --model_dir saved_exp/TCGA
