"""Precompute CLIP features of videos: <id>.safetensors {"feature": f16
[T, P_cur, D]}.

Port of the repo's scripts/extract_features.py, the extractor of the
features that the LLaVA family's feature-mode training
(train/train.py --feature-dir) and eval (eval/model_video_qa.py) read (the
reference's feature mode, train.py:700-760, model_msvd_qa_featuresloader.py):
each frame directory under --video_dir (`.npy` frames with numpy,
JPEG/PNG with PIL) -> CLIP preprocessing on the host -> `encode_frames`
(CLIP ViT, K1 on the card; the 2x2 merge when configured; `spatial_pool`
to the current memory's grid), --batch-frames frames a call -> f16,
written with the port's own safetensors writer. An output that already
exists is skipped; a video that fails is reported and the run goes on.
JAX pads the last batch to a fixed shape for its jit; frames encode
independently, so no padding is needed here.

    python -m flash_vstream_tpu_torch.scripts.extract_features --dry-run \\
        --device cpu --video_dir FRAMES --output_dir FEATS
    python -m flash_vstream_tpu_torch.scripts.extract_features \\
        --model-path DIR --video_dir FRAMES --output_dir FEATS
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional


def make_parser():
    p = argparse.ArgumentParser(description="CLIP feature extraction "
                                            "(PyTorch port)")
    p.add_argument("--model-path", default=None,
                   help="checkpoint with the CLIP tower (omit with --dry-run)")
    p.add_argument("--video_dir", required=True,
                   help="directory of frame directories, one per video")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--fps", type=float, default=1.0)
    p.add_argument("--max-frames", type=int, default=1200)
    p.add_argument("--batch-frames", type=int, default=32)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card)")
    p.add_argument("--dry-run", action="store_true")
    return p


def extract(args, cfg=None, params: Optional[dict] = None) -> List[str]:
    """Write every video's features; returns the names written. `cfg` and
    `params` replace the --dry-run or --model-path model."""
    import torch

    from ..models.vstream_llava import encode_frames
    from ..preprocess.image import clip_preprocess
    from ..preprocess.video import load_video
    from ..weights.safetensors_io import save_file

    if params is None:
        from ..runtime.pipeline import load_llava_model
        cfg, params, _ = load_llava_model(args.model_path, args.device,
                                          dry_run=args.dry_run)
    device = params["vit"]["patch_embed"]["w"].device
    os.makedirs(args.output_dir, exist_ok=True)
    bf = args.batch_frames
    written = []
    for vid in sorted(os.listdir(args.video_dir)):
        out_path = os.path.join(args.output_dir, vid + ".safetensors")
        if os.path.exists(out_path):
            continue
        try:
            frames = list(load_video(os.path.join(args.video_dir, vid),
                                     fps=args.fps,
                                     max_frames=args.max_frames))
            if not frames:
                raise ValueError("no frames")
            feats = []
            with torch.no_grad():
                for i in range(0, len(frames), bf):
                    imgs = torch.from_numpy(clip_preprocess(
                        frames[i:i + bf], cfg.vit.image_size))
                    feats.append(encode_frames(params, cfg,
                                               imgs.to(device)).cpu())
            feature = torch.cat(feats).to(torch.float16)
            save_file({"feature": feature}, out_path)
            written.append(vid)
            print(f"{vid}: {tuple(feature.shape)}")
        except Exception as e:
            print(f"failed {vid}: {e}")
    return written


def main(argv=None):
    return extract(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
