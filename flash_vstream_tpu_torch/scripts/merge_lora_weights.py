#!/usr/bin/env python3
"""Merge LoRA adapters into base weights and export one `.safetensors` file.

Port of scripts/merge_lora_weights.py. Both inputs are the port's own
checkpoint directories (`train/checkpoint.save_checkpoint`: the newest
`checkpoint-<step>/` holding {"params": ...}), the base's params a
parameter tree (bf16, f32 or quantized leaves) and the adapters' the flat
{path: {"a", "b"}} tree that `run_training` saves. `merge_lora` gives
w + (alpha / rank) a @ b at each adapted leaf (a quantized leaf is
dequantized first) and `export_safetensors` writes the merged tree.

    python -m flash_vstream_tpu_torch.scripts.merge_lora_weights \\
        --base-checkpoint BASE_DIR --lora-checkpoint RUN_DIR \\
        --output merged.safetensors [--rank 64 --alpha 32] [--device cpu]
"""
from __future__ import annotations

import argparse


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--base-checkpoint", required=True,
                   help="checkpoint directory of the base params")
    p.add_argument("--lora-checkpoint", required=True,
                   help="checkpoint directory of the adapter params")
    p.add_argument("--output", required=True, help="output .safetensors path")
    p.add_argument("--rank", type=int, default=64)
    p.add_argument("--alpha", type=float, default=32)
    p.add_argument("--device", default="cuda",
                   help="where the merge runs (default cuda; cpu for the "
                        "plain run without a card)")
    return p


def main(argv=None) -> str:
    args = make_parser().parse_args(argv)
    from ..core.device import resolve_device
    from ..train.checkpoint import export_safetensors, restore_checkpoint
    from ..train.lora import merge_lora_into_weights

    device = resolve_device(args.device)
    trees = []
    for d in (args.base_checkpoint, args.lora_checkpoint):
        restored = restore_checkpoint(d, map_location=device)
        if restored is None:
            raise FileNotFoundError(f"no checkpoint-<step>/ under {d}")
        trees.append(restored[1]["params"])
    merged = merge_lora_into_weights(*trees, alpha=args.alpha, rank=args.rank)
    export_safetensors(args.output, merged)
    print(f"merged weights written to {args.output}")
    return args.output


if __name__ == "__main__":
    main()
