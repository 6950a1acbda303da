"""Training recipes mirroring the reference's canonical runs.

A copy of flash_vstream_tpu/train/recipes.py:
- llava_pretrain: stage 1, projector(+NTM) only, lr 1e-3
  (Flash-VStream-LLaVA/scripts/train_and_eval.sh:27-60)
- llava_finetune: stage 2, everything except the vision tower, lr 2e-5 with
  an mm_projector_lr group (train_and_eval.sh:66-100)
- qwen_lora: LoRA r=64 alpha=32 over the LLM projections + merger, lr 8e-4
  (Flash-VStream-Qwen/scripts/train_and_eval.sh:3-59,
  finetune_flash.py:544-578)
"""
from __future__ import annotations

from .trainer import TrainConfig


def llava_pretrain(total_steps: int, grad_accum: int = 1) -> TrainConfig:
    return TrainConfig(
        learning_rate=1e-3,
        total_steps=total_steps,
        grad_accum=grad_accum,
        warmup_ratio=0.03,
        weight_decay=0.0,
        trainable=(r"^projector", r"^ntm"),
    )


def llava_finetune(total_steps: int, grad_accum: int = 1) -> TrainConfig:
    return TrainConfig(
        learning_rate=2e-5,
        projector_lr=2e-5,
        total_steps=total_steps,
        grad_accum=grad_accum,
        warmup_ratio=0.03,
        weight_decay=0.0,
        frozen=(r"^vit",),     # the vision tower stays frozen
    )


def qwen_lora(total_steps: int, grad_accum: int = 8) -> TrainConfig:
    # the adapter tree is the trainable tree; the base is frozen by
    # construction (train/lora.py), so no freeze regexes are needed here
    return TrainConfig(
        learning_rate=8e-4,
        total_steps=total_steps,
        grad_accum=grad_accum,
        warmup_ratio=0.03,
        weight_decay=0.0,
    )


QWEN_LORA_RANK = 64
QWEN_LORA_ALPHA = 32
