#!/bin/bash
# Real-time streaming QA demo on the card.
# Mirrors Flash-VStream-LLaVA/scripts/realtime_cli.sh (video_max_frames 1200,
# fps 1.0, play_speed 1.0) with the port's single-process streaming server,
# as scripts/realtime_cli.sh runs the JAX one. Run from the repository root.
set -e

MODEL_PATH=${MODEL_PATH:-checkpoints/flash-vstream-qwen-tpu-7b}
VIDEO=${VIDEO:-assets/example_frames}

python -m flash_vstream_tpu_torch.serve.cli_server \
    --model-family qwen \
    --model-path "$MODEL_PATH" \
    --video_file "$VIDEO" \
    --fps 1.0 --play_speed 1.0 \
    --video_max_frames 1200 \
    --question_interval 10 \
    --log_file logs/cli_server.log
