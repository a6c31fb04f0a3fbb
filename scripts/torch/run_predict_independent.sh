#!/bin/bash
# The PyTorch/CUDA port's counterpart of scripts/run_predict_independent.sh: the same command
# lines through sequoia_tpu_torch.cli, which run on CUDA.
# 5-fold pretrained-weight ensemble inference on an independent cohort
# (reference evaluation/predict_independent_dataset.py entry point)
python3 -m sequoia_tpu_torch.cli.predict_independent \
    --ref_file cohort_ref_file.csv \
    --feature_path features \
    --tcga_project TCGA-BRCA \
    --save_dir results --exp_name independent
