#!/bin/bash
# Two-stage LLaVA-family training + evaluation on the card.
# Mirrors Flash-VStream-LLaVA/scripts/train_and_eval.sh (STAR config:
# cur 1x8^2, long 25x4^2, Turing 25x1^2, weighted_kmeans; pretrain lr 1e-3,
# finetune lr 2e-5), as scripts/train_and_eval_llava.sh runs the JAX one.
# The port trains across ranks with one process a card: TP > 1 starts TP
# ranks (torch.distributed.run), each on its own card, at dp 1 x tp TP.
# Run from the repository root.
set -e

MODEL_PATH=${MODEL_PATH:-checkpoints/vicuna-7b-v1.5-clip336}
DATA_ROOT=${DATA_ROOT:-data}
OUT=${OUT:-checkpoints/flash-vstream-tpu-7b}
TP=${TP:-1}

RUN="python -m torch.distributed.run --standalone --nproc-per-node $TP"

# Stage 1: projector + NTM pretraining (plain template)
$RUN -m flash_vstream_tpu_torch.train.train \
    --stage pretrain \
    --model-path "$MODEL_PATH" \
    --data-path "$DATA_ROOT/pretrain/train.json" \
    --feature-dir "$DATA_ROOT/pretrain/features" \
    --output-dir "$OUT-pretrain" \
    --batch-size 32 --grad-accum 1 --epochs 1 \
    --learning-rate 1e-3 --tp "$TP"

# Stage 2: full finetune (vicuna_v1 template, vision tower frozen)
$RUN -m flash_vstream_tpu_torch.train.train \
    --stage finetune \
    --model-path "$MODEL_PATH" \
    --data-path "$DATA_ROOT/finetune/train.json" \
    --feature-dir "$DATA_ROOT/finetune/features" \
    --output-dir "$OUT" \
    --batch-size 16 --grad-accum 1 --epochs 1 \
    --learning-rate 2e-5 --tp "$TP"

# Evaluation over the feature-based QA sets
for DS in msvd msrvtt actnet nextoe vsmovienet vsego4d; do
    python -m flash_vstream_tpu_torch.eval.eval_any_dataset_features \
        --dataset "$DS" --data-root "$DATA_ROOT/eval_video" \
        --model-path "$OUT" --output-dir "eval_output/$DS"
done
