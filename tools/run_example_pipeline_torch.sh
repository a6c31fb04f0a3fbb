#!/bin/bash
# The PyTorch/CUDA port's counterpart of tools/run_example_pipeline.sh: the
# same chain through sequoia_tpu_torch.cli, on the same example data
# (tools/make_example_data.py writes the files both packages read).
#
# One-command replication of ALL FIVE BASELINE.md benchmark configs on
# synthetic data: WSIs -> tiles -> features -> k-means -> CV training ->
# per-gene evaluation -> serving, plus the HE2RNA baseline (config 3),
# UNI features + fold-ensemble independent inference (config 4), and
# GTEx pretrain -> head-swap fine-tune -> evaluate -> spatial expression
# maps (config 5).
#
# FULL=1 tools/run_example_pipeline_torch.sh   runs the chain at the REFERENCE
# width: the real 20,820-gene list is imported from a sequoia-pub checkout
# (REFERENCE=/root/reference by default) and every stage — training CV,
# all_genes.csv evaluation, serving, spatial maps — runs over the full
# panel.
# DEVICE=cpu runs every stage on the CPU (the CLIs run on CUDA by default
# and refuse without it).
set -e
OUT=${1:-/tmp/sequoia_example_torch}
DEV=(--device "${DEVICE:-cuda}")
FULL=${FULL:-0}
REFERENCE=${REFERENCE:-/root/reference}
REPO="$(cd "$(dirname "$0")/.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
rm -rf "$OUT" && mkdir -p "$OUT"

GENE_ARGS=(--n_genes 50)
if [ "$FULL" = "1" ]; then
    python tools/import_reference_artifacts.py --reference "$REFERENCE" \
        --out "$OUT/ref_artifacts"
    GENE_ARGS=(--gene_list "$OUT/ref_artifacts/examples/gene_list.csv" \
               --n_genes -1)
fi

python tools/make_example_data.py --out "$OUT" --n_slides 12 \
    "${GENE_ARGS[@]}" --wsis

# ---- config 2: tiling + ResNet-50 feature extraction --------------------
python -m sequoia_tpu_torch.cli.patch_gen \
    --wsi_path "$OUT/HE" --patch_path "$OUT/patches" --mask_path "$OUT/patches" \
    --patch_size 64 --max_patches_per_slide 60 "${DEV[@]}"

python -m sequoia_tpu_torch.cli.compute_features --feat_type resnet \
    --ref_file "$OUT/ref_file.csv" --patch_data_path "$OUT/patches" \
    --feature_path "$OUT/features" --weights random --batch_size 32 \
    --max_patch_number 48 "${DEV[@]}"

python -m sequoia_tpu_torch.cli.kmean_features --ref_file "$OUT/ref_file.csv" \
    --feature_path "$OUT/features" --num_clusters 8 "${DEV[@]}"

# ---- config 1 (+3 of BASELINE's CV contract): ViS 2-fold CV train/eval --
python -m sequoia_tpu_torch.cli.main --ref_file "$OUT/ref_file.csv" \
    --feature_path "$OUT/features" --model_type vis --depth 1 --num-heads 2 \
    --k 2 --batch_size 4 --num_epochs 2 --train \
    --save_dir "$OUT/exp" --cohort syn --exp_name demo "${DEV[@]}"

python -m sequoia_tpu_torch.cli.evaluate_model --model_dir "$OUT/exp/syn" \
    --cancers demo --folds 2 --save_path "$OUT/results"

# ---- config 3: HE2RNA MLP aggregation baseline (2-fold CV) --------------
python -m sequoia_tpu_torch.cli.he2rna --path_csv "$OUT/ref_file.csv" \
    --feature_path "$OUT/features" --k 2 --batch_size 4 \
    --destfolder "$OUT" --subfolder exp_he2rna --exp_name demo "${DEV[@]}"

# ---- config 4: UNI ViT-L features + fold-ensemble independent inference -
python -m sequoia_tpu_torch.cli.compute_features --feat_type uni \
    --ref_file "$OUT/ref_file.csv" --patch_data_path "$OUT/patches" \
    --feature_path "$OUT/features_uni" --weights random --batch_size 16 \
    --max_patch_number 16 "${DEV[@]}"

python -m sequoia_tpu_torch.cli.kmean_features --ref_file "$OUT/ref_file.csv" \
    --feature_path "$OUT/features_uni" --feat_name uni_features \
    --num_clusters 8 "${DEV[@]}"

python -m sequoia_tpu_torch.cli.main --ref_file "$OUT/ref_file.csv" \
    --feature_path "$OUT/features_uni" --model_type vis --depth 1 \
    --num-heads 2 --k 2 --batch_size 4 --num_epochs 2 --train \
    --save_dir "$OUT/exp_uni" --cohort syn --exp_name demo "${DEV[@]}"

python -m sequoia_tpu_torch.cli.predict_independent --ref_file "$OUT/ref_file.csv" \
    --feature_path "$OUT/features_uni" \
    --checkpoint_template "$OUT/exp_uni/syn/demo/model_best_{fold}.pt" \
    --folds 2 --depth 1 --num-heads 2 \
    --save_dir "$OUT/results_independent" --exp_name ind "${DEV[@]}"

# ---- config 5: GTEx pretrain -> head-swap fine-tune -> eval -> spatial --
# GTEx cohort: different (40-gene) panel + ready-made cluster features, so
# the fine-tune exercises the real head swap (reference main.py:138-157)
# n_tokens matches the TCGA chain's --num_clusters so the pretrained
# pos-emb transfers (the reference contract fixes both at 100)
python tools/make_example_data.py --out "$OUT/gtex" --n_slides 8 \
    --n_genes 40 --project GTEX-SYNT --features --n_tokens 8

python -m sequoia_tpu_torch.cli.pretrain_gtex --path_csv "$OUT/gtex/ref_file.csv" \
    --feature_path "$OUT/gtex/features" --model vis --num_epochs 2 \
    --batch_size 4 --save_dir "$OUT/pretrain" --exp_name gtex "${DEV[@]}"

PRETRAINED=$(ls -d "$OUT"/pretrain/*_gtex)/model_best.pt

python -m sequoia_tpu_torch.cli.main --ref_file "$OUT/ref_file.csv" \
    --feature_path "$OUT/features" --model_type vis \
    --checkpoint "$PRETRAINED" --change_num_genes 40 \
    --k 2 --batch_size 4 --num_epochs 2 --train \
    --save_dir "$OUT/exp_ft" --cohort syn --exp_name ft "${DEV[@]}"

python -m sequoia_tpu_torch.cli.evaluate_model --model_dir "$OUT/exp_ft/syn" \
    --cancers ft --folds 2 --save_path "$OUT/results_ft"

# spatial expression maps from the fine-tuned folds (reference
# visualize.py TCGA path layout; featurize-once sliding window)
SPATIAL_ROOT="$OUT/spatial_root"
mkdir -p "$SPATIAL_ROOT/TCGA/TCGA-SYNT" \
         "$SPATIAL_ROOT/TCGA/TCGA-SYNT_Masks/TCGA-SYNT-0000"
SLIDE0=$(ls "$OUT"/HE/*.tiff | head -1)
STEM0=$(basename "$SLIDE0" .tiff)
cp "$SLIDE0" "$SPATIAL_ROOT/TCGA/TCGA-SYNT/TCGA-SYNT-0000.svs"
cp "$OUT/patches/$STEM0/mask.npy" \
   "$SPATIAL_ROOT/TCGA/TCGA-SYNT_Masks/TCGA-SYNT-0000/mask.npy"
GENE0=$(python -c "import pandas as pd,sys; \
print(pd.read_csv('$OUT/gene_list.csv')['gene_name'].iloc[0])")
(cd "$SPATIAL_ROOT" && python -m sequoia_tpu_torch.cli.visualize \
    --study ft --project TCGA-SYNT --gene_names "$GENE0" \
    --wsi_file_name TCGA-SYNT-0000.svs --save_folder maps \
    --model_type vis --feat_type resnet --folds 0,1 --stride 4 \
    --patch_size 64 --data_root . \
    --checkpoint_dir "$OUT/exp_ft/syn/ft" --weights random --batch_size 32 "${DEV[@]}")
cp "$SPATIAL_ROOT/visualizations/TCGA-SYNT/maps/TCGA-SYNT-0000.svs/stride-4.csv" \
   "$OUT/results_ft/stride-4.csv"

# ---- one-shot serving through the streaming predictor -------------------
python -m sequoia_tpu_torch.cli.serve --wsi "$OUT"/HE/*.tiff \
    --checkpoints "$OUT/exp/syn/demo" --weights random --batch_size 32 \
    --compute_dtype float32 --max_patches 48 --patch_size 64 \
    --num_clusters 8 --out "$OUT/results/predictions.csv" "${DEV[@]}"

echo "--- results ---"
ls "$OUT/results" "$OUT/results_ft" "$OUT/results_independent/ind" \
   "$OUT/exp_he2rna/demo"
