#!/bin/bash
# The PyTorch/CUDA port's counterpart of scripts/run_fleet_features.sh: the same command
# lines through sequoia_tpu_torch.cli, which run on CUDA.
# Multi-host feature-extraction fleet: run this SAME command on every host
# (set PROC_ID per host, e.g. from SLURM_PROCID; on Cloud TPU pods the
# coordinator/count/id are discovered automatically — drop those flags).
# Each process works a deterministic shard of the ref file and writes the
# standard per-slide artifacts (docs/DEPLOYMENT.md).
: "${NUM_HOSTS:=2}" "${PROC_ID:=0}" "${COORD:=host0:8476}"
python3 -m sequoia_tpu_torch.cli.compute_features \
    --multihost --coordinator "$COORD" \
    --num_processes "$NUM_HOSTS" --process_id "$PROC_ID" \
    --feat_type resnet --compute_dtype bfloat16 --batch_size 128 \
    --ref_file examples/ref_file.csv \
    --patch_data_path examples/Patches_hdf5 \
    --feature_path examples/features \
    --weights /path/to/resnet50.pth
