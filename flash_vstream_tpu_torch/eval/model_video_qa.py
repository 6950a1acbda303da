"""LLaVA-family video-QA eval worker over precomputed features or frame
directories.

Port of flash_vstream_tpu/eval/model_video_qa.py, the CLI rebuild of
Flash-VStream-LLaVA/flash_vstream/eval_video/
model_msvd_qa_featuresloader.py (precomputed features) and model_msvd_qa.py
(raw frames at 1 fps):
- a sample's "system" text goes before its question (featuresloader
  L73-75);
- round-robin chunking (--num-chunks/--chunk-idx) and resume from an
  existing answers file (L125-134);
- greedy decode by default (the reference samples at temperature 0.002,
  L151-152; --temperature takes it);
- a feature file that fails to load is replaced by a random sample's, up to
  10 times (L62-68); a sample that fails is printed and skipped.

Features load from `<video_dir>/<id>.safetensors` through the port's own
reader (key "feature", else the first) or `<id>.npy`; they go through
`LLaVAPipeline.answer(..., features=...)` as f32 on the pipeline's device.
`--raw-frames` reads `<video_dir>/<id>/` frame directories (`.npy` frames
with numpy, JPEG/PNG with PIL). The model is `load_llava_model`'s:
`--dry-run` the tiny config with random weights and the byte tokenizer,
else `--model-path` in bf16 with its HF tokenizer (`transformers`), on the
card unless `--device` says otherwise.

    python -m flash_vstream_tpu_torch.eval.model_video_qa --dry-run \\
        --device cpu --video_dir FEATS --gt_file QA.json --output_dir OUT
"""
from __future__ import annotations

import argparse
import json
import os
import random

import numpy as np


def load_features(video_dir: str, video_id: str) -> np.ndarray:
    """[T, P, D] features of one video (`.safetensors`, else `.npy`)."""
    from ..train.data import load_feature_file
    return load_feature_file(os.path.join(video_dir, video_id))


def build_pipeline(args):
    """The LLaVAPipeline of `load_llava_model` on --device (default: the
    card)."""
    from ..runtime.pipeline import LLaVAPipeline, load_llava_model
    cfg, params, tokenizer = load_llava_model(args.model_path, args.device,
                                              dry_run=args.dry_run)
    if args.dry_run:
        return LLaVAPipeline(params, cfg, tokenizer, max_len=1024)
    return LLaVAPipeline(params, cfg, tokenizer,
                         conv_template=args.conv_mode)


def run_inference(args, pipeline=None) -> str:
    """Answer one chunk of the ground-truth file into its answers file (one
    JSON record a line, appended; ids already there are skipped); returns
    the file's path."""
    import torch

    from ..runtime.generation import GenerationConfig

    with open(args.gt_file) as f:
        questions = json.load(f)[args.chunk_idx::args.num_chunks]
    os.makedirs(args.output_dir, exist_ok=True)
    answers_file = os.path.join(args.output_dir, f"{args.output_name}.json")
    if os.path.exists(answers_file):
        with open(answers_file) as f:
            done = {json.loads(row)["id"] for row in f if row.strip()}
        questions = [q for q in questions if q["id"] not in done]

    if pipeline is None:
        pipeline = build_pipeline(args)
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens,
                           temperature=args.temperature,
                           eos_token_ids=(pipeline.tokenizer.eos_token_id,))

    rng = random.Random(0)
    with open(answers_file, "a") as ans:
        for sample in questions:
            try:
                vid = sample.get("video_id") or sample.get("video_name")
                q = sample["question"]
                if "system" in sample:
                    q = sample["system"] + " " + q
                if args.use_features:
                    feats = None
                    for _ in range(10):
                        try:
                            feats = load_features(args.video_dir, vid)
                            break
                        except Exception as e:
                            print(f"feature load failed ({e}); resampling")
                            sample = rng.choice(questions)
                            vid = (sample.get("video_id")
                                   or sample.get("video_name"))
                    feats = torch.from_numpy(np.asarray(feats, np.float32))
                    pred = pipeline.answer(
                        None, q, gen=gen,
                        features=feats.to(pipeline.device))
                else:
                    from ..preprocess.video import load_video
                    src = load_video(os.path.join(args.video_dir, vid),
                                     fps=1.0, max_frames=args.max_frames)
                    pred = pipeline.answer(list(src), q, gen=gen)
                out = dict(sample)
                out["pred"] = pred
                ans.write(json.dumps(out) + "\n")
                ans.flush()
            except Exception as e:      # the reference goes on past a sample
                print(f"error on id={sample.get('id')}: {e!r}")
                continue
    return answers_file


def make_parser():
    p = argparse.ArgumentParser(description="LLaVA-family video QA eval "
                                            "worker (PyTorch port)")
    p.add_argument("--model-path", type=str, default=None)
    p.add_argument("--video_dir", required=True)
    p.add_argument("--gt_file", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--output_name", default="pred")
    p.add_argument("--conv-mode", default="vicuna_v1")
    p.add_argument("--num-chunks", type=int, default=1)
    p.add_argument("--chunk-idx", type=int, default=0)
    p.add_argument("--use-features", action="store_true", default=True)
    p.add_argument("--raw-frames", dest="use_features", action="store_false")
    p.add_argument("--max-frames", type=int, default=50)
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="the reference uses 0.002 (near-greedy); 0 = greedy")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain PyTorch versions of the kernels)")
    p.add_argument("--dry-run", action="store_true")
    return p


def main(argv=None):
    return run_inference(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
