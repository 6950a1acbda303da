"""Evaluation orchestrator: dataset registry, chunked workers, scoring.

Port of flash_vstream_tpu/eval/eval_any_dataset.py (the CLI-compatible
rebuild of Flash-VStream-Qwen/eval_any_dataset.py):
- the 12-dataset registry rooted at --data-root (VideoChatGPT as three
  splits, each inferred into its own subdirectory);
- chunked inference: one chunk runs in this process, more run as
  subprocesses `python -m flash_vstream_tpu_torch.eval.inference_mcq_vqa`,
  one a chunk, started together; a worker that exits non-zero is printed
  and the run goes on, as the reference does;
- MCQ scoring with per-dataset breakdowns, or the GPT judge for
  open-ended sets.

Workers run on the card unless `--device` is given, which is passed on
to them (JAX passes `--platform cpu` when its parent runs on the CPU).

    python -m flash_vstream_tpu_torch.eval.eval_any_dataset --dry-run \\
        --dataset mvbench --data-root DATA --output-dir OUT \\
        [--num-chunks 2] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional

from .scoring import calc_mcq_result

DATASETS = [
    {"type": "mc", "dataset_name": "egoschema", "frame_dir": "EgoSchema/frames", "data_file": "EgoSchema/test_qa.json"},
    {"type": "mc", "dataset_name": "egoschema_all", "frame_dir": "EgoSchema/frames", "data_file": "EgoSchema/all_qa.json"},
    {"type": "mc", "dataset_name": "videommesub", "frame_dir": "videomme/frames", "data_file": "videomme/test_qa.json"},
    {"type": "mc", "dataset_name": "videommewo", "frame_dir": "videomme/frames", "data_file": "videomme/test_qa.json"},
    {"type": "mc", "dataset_name": "mvbench", "frame_dir": "mvbench/frames", "data_file": "mvbench/test_qa.json"},
    {"type": "mc", "dataset_name": "lvbench", "frame_dir": "lvbench/frames", "data_file": "lvbench/test_qa.json"},
    {"type": "mc", "dataset_name": "mlvu", "frame_dir": "mlvu/frames", "data_file": "mlvu/test_qa.json"},
    {"type": "oe", "dataset_name": "rvs_ego", "frame_dir": "vstream-realtime/ego4d_frames", "data_file": "vstream-realtime/test_qa_ego4d.json"},
    {"type": "oe", "dataset_name": "rvs_movie", "frame_dir": "vstream-realtime/movienet_frames", "data_file": "vstream-realtime/test_qa_movienet.json"},
    {"type": "oe", "dataset_name": "actnet", "frame_dir": "ActivityNet-QA/test_frames", "data_file": "ActivityNet-QA/test_qa.json"},
    {"type": "oe", "dataset_name": "nextoe", "frame_dir": "nextoe/nextoe_frames", "data_file": "nextoe/test_qa.json"},
    {"type": "oe", "dataset_name": "videochatgpt", "frame_dir": "VideoChatGPTBench/video_10000frames_high_fps1",
     "data_file": ["VideoChatGPTBench/test_generic_qa.json",
                   "VideoChatGPTBench/test_temporal_qa.json",
                   "VideoChatGPTBench/test_consistency_qa.json"],
     "splits": ["generic", "temporal", "consistency"]},
]


def get_dataset_info(dataset: str, data_root: str,
                     use_high_fps: bool = False) -> Optional[dict]:
    for d in DATASETS:
        if d["dataset_name"] == dataset:
            out = dict(d)
            out["frame_dir"] = os.path.join(data_root, d["frame_dir"])
            if isinstance(d["data_file"], list):
                out["data_file"] = [os.path.join(data_root, f)
                                    for f in d["data_file"]]
            else:
                out["data_file"] = os.path.join(data_root, d["data_file"])
            if use_high_fps:
                out["frame_dir"] = out["frame_dir"].replace("frames",
                                                            "frames_fps4")
            return out
    return None


def launch_workers(args, info: dict, data_file: Optional[str] = None,
                   output_dir: Optional[str] = None) -> List[str]:
    """Run inference over all chunks; returns the answers files. One chunk
    runs in this process; more run as subprocesses, each on --device when
    it was given."""
    from . import inference_mcq_vqa as worker

    output_dir = output_dir or args.output_dir
    common = [
        "--dataset", args.dataset,
        "--video-dir", info["frame_dir"],
        "--data-file", data_file or info["data_file"],
        "--output-dir", output_dir,
        "--num-chunks", str(args.num_chunks),
        "--max-frames", str(args.max_frames),
        "--max-pixels", str(args.max_pixels),
    ]
    for flag, value in (("--model-path", args.model_path),
                        ("--flash-memory-dict", args.flash_memory_dict),
                        ("--subtitle-dir", args.subtitle_dir),
                        ("--device", args.device)):
        if value:
            common += [flag, value]
    if args.fps is not None:
        common += ["--fps", str(args.fps)]
    if args.dry_run:
        common += ["--dry-run"]
    if args.reproduce:
        common += ["--reproduce"]

    if args.num_chunks == 1:
        wargs = worker.make_parser().parse_args(common + ["--chunk-idx", "0"])
        return [worker.run_inference(wargs)]
    procs, files = [], []
    for i in range(args.num_chunks):
        cmd = [sys.executable, "-m",
               "flash_vstream_tpu_torch.eval.inference_mcq_vqa",
               *common, "--chunk-idx", str(i)]
        procs.append(subprocess.Popen(cmd))
        files.append(os.path.join(output_dir, f"{args.num_chunks}_{i}.json"))
    for p in procs:
        ret = p.wait()
        if ret != 0:
            print(f"worker exited with {ret}")
    return files


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Flash-VStream evaluation (PyTorch port)")
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--data-root", type=str, default="data/eval_video")
    p.add_argument("--model-path", type=str, default=None)
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--num-chunks", type=int, default=1)
    p.add_argument("--fps", type=float, default=None)
    p.add_argument("--max-frames", type=int, default=240)
    p.add_argument("--max-pixels", type=int, default=4 * 224 * 224)
    p.add_argument("--flash-memory-dict", type=str, default=None)
    p.add_argument("--use-high-fps", action="store_true")
    p.add_argument("--reproduce", action="store_true",
                   help="paper-reproduction frame sampling (every 4th)")
    p.add_argument("--subtitle-dir", type=str, default=None,
                   help="<video_id>.srt directory (videommesub)")
    p.add_argument("--judge-model", type=str, default="gpt-3.5-turbo-0125")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--skip-inference", action="store_true",
                   help="score existing prediction files only")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the workers (default: the card)")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    info = get_dataset_info(args.dataset, args.data_root, args.use_high_fps)
    if info is None:
        raise SystemExit(f"unknown dataset {args.dataset}; known: "
                         f"{[d['dataset_name'] for d in DATASETS]}")
    os.makedirs(args.output_dir, exist_ok=True)

    multi_split = isinstance(info["data_file"], list)
    if not args.skip_inference:
        if multi_split:
            for split, data_file in zip(info["splits"], info["data_file"]):
                launch_workers(args, info, data_file=data_file,
                               output_dir=os.path.join(args.output_dir,
                                                       split))
        else:
            launch_workers(args, info)

    if info["type"] == "mc":
        calc_mcq_result(args.output_dir, args.num_chunks, info["data_file"],
                        dataset_name=args.dataset)
        return
    from .scoring import load_predictions
    if multi_split:
        from .gpt_judge import judge_videochatgpt
        preds_by_split = {
            split: load_predictions(os.path.join(args.output_dir, split),
                                    args.num_chunks)
            for split in info["splits"]}
        summary = judge_videochatgpt(preds_by_split, args.output_dir,
                                     model=args.judge_model)
    else:
        from .gpt_judge import aggregate, judge_all
        preds = load_predictions(args.output_dir, args.num_chunks)
        summary = aggregate(judge_all(
            preds, os.path.join(args.output_dir, "judge.json"),
            model=args.judge_model))
    print(json.dumps(summary, indent=2))
    with open(os.path.join(args.output_dir, "result.json"), "w") as f:
        json.dump(summary, f, indent=2)


if __name__ == "__main__":
    main()
