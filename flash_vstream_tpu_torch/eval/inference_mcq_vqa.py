"""Batch inference worker: MCQ / open-ended video QA over a dataset chunk.

Port of flash_vstream_tpu/eval/inference_mcq_vqa.py, the CLI-compatible
rebuild of Flash-VStream-Qwen/inference_mcq_vqa.py:
- round-robin chunking (--num-chunks/--chunk-idx),
- resume from an existing answers file,
- dataset-specific prompts, with the MCQ "Best option: (" priming,
- frame-directory sampling by fps, max_frames, fps4 pairs, rvs_movie
  duplicate pairs or --reproduce,
- consistency samples (question1/question2) answered twice over one set of
  frames, as pred1/pred2,
- per-sample try/except-continue, as the reference: a sample that fails
  is printed and left out of the answers file,
- greedy decode.

The model is a `QwenPipeline` (runtime/pipeline.py): from a checkpoint
directory (`--model-path`: the weights in bf16, the config from its
config.json, the HF tokenizer, which needs `transformers`), or the tiny
config with random weights and the byte tokenizer (`--dry-run`). It runs
on the card unless `--device cpu` is given. Frames load from `.npy` files
(one uint8 [H, W, 3] array each) with numpy, from JPEG files through the
port's decoder (native/io.py) and from any other image file with PIL,
imported only then.

    python -m flash_vstream_tpu_torch.eval.inference_mcq_vqa --dry-run \\
        --dataset mvbench --video-dir DIR --data-file QA.json \\
        --output-dir OUT [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np

MCQ_PROMPT = ("Select the best answer to the following multiple-choice "
              "question based on the video. Respond with only the letter "
              "(A, B, C, or D) of the correct option.")
MCQ_SUB_PROMPT = ("Select the best answer to the following multiple-choice "
                  "question based on the video and the subtitles. Respond "
                  "with only the letter (A, B, C, or D) of the correct "
                  "option.")
OE_PROMPT = "Answer the following open-ended question based on the video. "
OE_DATASETS = ("rvs_ego", "rvs_movie", "actnet", "nextoe", "videochatgpt")


def get_chunk(lst: List, n: int, k: int) -> List:
    """Round-robin chunking: items k, k + n, k + 2n, ..."""
    return lst[k::n]


def _frame_index(name: str) -> int:
    stem = name.split("_")[-1].split(".")[0]
    return int(stem) if stem.isdigit() else 0


def sample_frame_paths(video_dir: str, fps: Optional[float],
                       max_frames: Optional[int],
                       source_fps: float = 1.0, dataset: str = "",
                       reproduce: bool = False) -> List[str]:
    """The frame files of one video to answer over, in the reference's
    modes: every 4th with `reproduce`; an fps subsample (uncapped: the
    reference ignores max_frames there); for rvs_movie each of up to
    max_frames / 2 linspaced frames twice; every frame when they fit;
    (i, i + 1) pairs from a `frames_fps4` directory (an odd max_frames
    rounds down to even); else max_frames linspaced."""
    names = sorted(os.listdir(video_dir), key=_frame_index)
    paths = [os.path.join(video_dir, n) for n in names]
    if reproduce:
        return paths[::4]
    T = len(paths)
    if fps is not None:
        if fps < source_fps:
            step = max(int(round(source_fps / fps)), 1)
            paths = paths[::step]
        return paths
    if "rvs_movie" in dataset:
        n = min(T, (max_frames or 2 * T) // 2)
        idx = np.linspace(0, T - 1, max(n, 1)).round().astype(int)
        return [p for i in idx for p in (paths[i], paths[i])]
    if max_frames is None or T <= max_frames:
        return paths
    if "frames_fps4" in video_dir:
        if max_frames % 2:
            even = max(max_frames - 1, 2)
            print(f"[sample_frame_paths] fps4 dirs sample frame pairs; "
                  f"rounding odd max_frames {max_frames} to {even}")
            max_frames = even
        idx = np.linspace(0, T - 1, max_frames // 2).round().astype(int)
        out = []
        for i in idx:
            a, b = (i, i + 1) if i < T - 1 else (i - 1, i)
            out += [paths[a], paths[b]]
        return out
    idx = np.linspace(0, T - 1, max_frames).round().astype(int)
    return [paths[i] for i in idx]


def load_frames(paths: List[str]) -> List[np.ndarray]:
    """uint8 [H, W, 3] frames at their own size (preprocess/video.py
    `read_frame`: `.npy` with numpy, JPEG through the port's decoder, other
    images through PIL)."""
    from ..preprocess.video import read_frame
    return [read_frame(p) for p in paths]


def build_question(sample: dict, dataset: str, subtitle: str = "",
                   q_base: Optional[str] = None) -> tuple:
    """(prompt, is_mcq) of one question of a sample."""
    q = q_base or sample.get("question") or sample.get("question1")
    if dataset in OE_DATASETS:
        return OE_PROMPT + q, False
    if "videommesub" in dataset and subtitle:
        return ("This video's subtitles are listed below: \n" + subtitle
                + "\n" + MCQ_SUB_PROMPT + q), True
    return MCQ_PROMPT + q, True


def run_inference(args, pipeline=None) -> str:
    """Answer one chunk of the data file into its answers file (one JSON
    record a line, appended; ids already there are skipped); returns the
    file's path. `pipeline` defaults to `build_pipeline(args)`."""
    from ..runtime.generation import GenerationConfig

    with open(args.data_file) as f:
        gt_questions = get_chunk(json.load(f), args.num_chunks,
                                 args.chunk_idx)
    os.makedirs(args.output_dir, exist_ok=True)
    name = (f"{args.num_chunks}_{args.chunk_idx}" if args.num_chunks > 1
            else args.output_name)
    answers_file = os.path.join(args.output_dir, f"{name}.json")
    if os.path.exists(answers_file):
        with open(answers_file) as f:
            done = {json.loads(row)["id"] for row in f if row.strip()}
        gt_questions = [s for s in gt_questions if s["id"] not in done]
    if pipeline is None:
        pipeline = build_pipeline(args)
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens,
                           eos_token_ids=(pipeline.tokenizer.eos_token_id,))

    with open(answers_file, "a") as ans_file:
        for sample in gt_questions:
            try:
                video_path = os.path.join(args.video_dir, sample["video_id"])
                if not os.path.exists(video_path):
                    raise FileNotFoundError(video_path)
                paths = sample_frame_paths(video_path, args.fps,
                                           args.max_frames,
                                           dataset=args.dataset,
                                           reproduce=args.reproduce)
                subtitle = ""
                if "videommesub" in args.dataset and args.subtitle_dir:
                    from .subtitles import get_subtitle
                    idxs = [_frame_index(os.path.basename(p)) for p in paths
                            if os.path.basename(p).split("_")[-1]
                            .split(".")[0].isdigit()]
                    subtitle = get_subtitle(args.subtitle_dir,
                                            sample["video_id"], idxs)
                q_bases = ([sample["question"]] if "question" in sample
                           else [sample["question1"], sample["question2"]])
                frames = load_frames(paths)
                preds = []
                for q_base in q_bases:
                    question, is_mcq = build_question(
                        sample, args.dataset, subtitle, q_base=q_base)
                    if is_mcq:
                        question += "\nBest option: ("
                    preds.append(pipeline.answer(frames, question, gen=gen))
                record = dict(sample)
                if "question" in sample:
                    record["pred"] = preds[0]
                else:
                    record["pred1"], record["pred2"] = preds
                ans_file.write(json.dumps(record) + "\n")
                ans_file.flush()
            except Exception as e:      # the reference goes on past a sample
                print(f"[chunk {args.chunk_idx}] error on id="
                      f"{sample.get('id')}: {e!r}")
                continue
    return answers_file


def build_pipeline(args):
    """The QwenPipeline of `load_qwen_model` (--dry-run or --model-path) on
    --device (default: the card)."""
    from ..runtime.pipeline import QwenPipeline, load_qwen_model
    cfg, params, tokenizer = load_qwen_model(
        args.model_path, args.device, dry_run=args.dry_run,
        flash_memory_dict=args.flash_memory_dict)
    return QwenPipeline(params, cfg, tokenizer,
                        max_len=2048 if args.dry_run else 16384,
                        max_pixels=args.max_pixels)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Flash-VStream batch inference (PyTorch port)")
    p.add_argument("--model-path", type=str, default=None)
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--video-dir", type=str, required=True)
    p.add_argument("--data-file", type=str, required=True)
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--output-name", type=str, default="pred")
    p.add_argument("--num-chunks", type=int, default=1)
    p.add_argument("--chunk-idx", type=int, default=0)
    p.add_argument("--fps", type=float, default=None)
    p.add_argument("--max-frames", type=int, default=240)
    p.add_argument("--max-pixels", type=int, default=4 * 224 * 224)
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--flash-memory-dict", type=str, default=None)
    p.add_argument("--subtitle-dir", type=str, default=None,
                   help="directory of <video_id>.srt files (videommesub)")
    p.add_argument("--dry-run", action="store_true",
                   help="tiny random-init model (no checkpoint needed)")
    p.add_argument("--reproduce", action="store_true",
                   help="paper-reproduction sampling: every 4th frame")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain PyTorch versions of the kernels)")
    return p


def main(argv=None):
    return run_inference(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
