#!/bin/bash
# The PyTorch/CUDA port's counterpart of scripts/run_serve.sh: the same command
# lines through sequoia_tpu_torch.cli, which run on CUDA.
# Production serving (docs/DEPLOYMENT.md "Serving"): one-shot bulk scoring
# of WSIs into a predictions CSV, or a resident HTTP endpoint.
#
#   scripts/torch/run_serve.sh slide1.svs slide2.svs      # one-shot CSV
#   HTTP_PORT=8000 scripts/torch/run_serve.sh             # resident server
#
# CKPTS accepts a CV output dir (model_best_{i}.pt folds auto-ensembled),
# a single .pt, or an HF-layout dir. PANEL=EGFR,MKI67 restricts output to
# a gene panel (slices the ViS head before jit).
: "${CKPTS:=saved_exp/TCGA/exp_vis}" "${WEIGHTS:=/path/to/resnet50.pth}"
: "${GENES:=examples/gene_list.csv}" "${CACHE_DIR:=/tmp/sequoia_xla_cache}"
EXTRA=()
[ -n "$PANEL" ] && EXTRA+=(--panel "$PANEL")
if [ -n "$HTTP_PORT" ]; then
    exec python3 -m sequoia_tpu_torch.cli.serve \
        --http "$HTTP_PORT" \
        --checkpoints "$CKPTS" --weights "$WEIGHTS" \
        --feat_type resnet --compute_dtype bfloat16 \
        --gene_names "$GENES" \
        --compilation_cache "$CACHE_DIR" "${EXTRA[@]}"
fi
python3 -m sequoia_tpu_torch.cli.serve \
    --wsi "$@" \
    --checkpoints "$CKPTS" --weights "$WEIGHTS" \
    --feat_type resnet --compute_dtype bfloat16 \
    --gene_names "$GENES" \
    --compilation_cache "$CACHE_DIR" "${EXTRA[@]}" \
    --out predictions.csv
