#!/bin/bash
# Qwen-family LoRA fine-tune + benchmark evaluation on the card.
# Mirrors Flash-VStream-Qwen/scripts/train_and_eval.sh (LoRA r=64 alpha=32,
# lr 8e-4, grad-accum 8, max_pixels 4*224^2, max_frames 240) through the
# port's trainer, as scripts/train_and_eval_qwen.sh runs the JAX one. Run
# from the repository root.
set -e

MODEL_PATH=${MODEL_PATH:-checkpoints/Qwen2-VL-7B-Instruct}
DATA_ROOT=${DATA_ROOT:-data}
OUT=${OUT:-checkpoints/flash-vstream-qwen-tpu-7b}

python -m flash_vstream_tpu_torch.train.finetune_flash \
    --model-path "$MODEL_PATH" \
    --data-path "$DATA_ROOT/finetune/train.json" \
    --video-dir "$DATA_ROOT/finetune/frames" \
    --output-dir "$OUT" \
    --lora-rank 64 --lora-alpha 32 \
    --learning-rate 8e-4 --grad-accum 8 \
    --max-frames 240 --max-pixels 200704 \
    --flash-memory-dict '{"flash_memory_temporal_length": 120, "flash_memory_temporal_method": "kmeans_ordered", "flash_memory_temporal_poolsize": 2, "flash_memory_temporal_pca_dim": 32, "flash_memory_spatial_length": 60, "flash_memory_spatial_method": "klarge_retrieve"}'

# Benchmark evaluation (MCQ sets)
for DS in egoschema videommewo mvbench lvbench mlvu; do
    python -m flash_vstream_tpu_torch.eval.eval_any_dataset \
        --dataset "$DS" --data-root "$DATA_ROOT/eval_video" \
        --model-path "$OUT" --output-dir "eval_output/$DS" \
        --max-frames 240
done
