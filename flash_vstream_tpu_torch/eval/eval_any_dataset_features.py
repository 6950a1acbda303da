"""LLaVA-family eval launcher over feature-based QA sets.

Port of flash_vstream_tpu/eval/eval_any_dataset_features.py, the CLI
rebuild of Flash-VStream-LLaVA/flash_vstream/eval_video/
eval_any_dataset_features.py: the dataset table of precomputed-feature QA
sets (msvd, msrvtt, actnet, nextoe, the VStream movienet/ego4d sets and
their realtime variants) rooted at --data-root; inference in chunks (one
in this process, more as subprocesses `python -m
flash_vstream_tpu_torch.eval.model_video_qa`, started together, each given
--device when it was given); then the GPT judge over the predictions
(`--skip-judge` leaves it out).

    python -m flash_vstream_tpu_torch.eval.eval_any_dataset_features \\
        --dataset msvd --data-root DATA --output-dir OUT --dry-run \\
        --device cpu --skip-judge [--num-chunks 2]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

DATASETS = {
    "msvd": {"features": "msvd/features", "gt": "msvd/test_qa.json"},
    "msrvtt": {"features": "msrvtt/features", "gt": "msrvtt/test_qa.json"},
    "actnet": {"features": "actnet/features", "gt": "actnet/test_qa.json"},
    "nextoe": {"features": "nextoe/features", "gt": "nextoe/test_qa.json"},
    "vsmovienet": {"features": "vstream/movienet_features",
                   "gt": "vstream/test_qa_movienet.json"},
    "vsego4d": {"features": "vstream/ego4d_features",
                "gt": "vstream/test_qa_ego4d.json"},
    "realtime_vsmovienet": {"features": "vstream-realtime/movienet_features",
                            "gt": "vstream-realtime/test_qa_movienet.json"},
    "realtime_vsego4d": {"features": "vstream-realtime/ego4d_features",
                         "gt": "vstream-realtime/test_qa_ego4d.json"},
}


def main(argv=None):
    p = argparse.ArgumentParser(description="Flash-VStream LLaVA feature "
                                            "eval (PyTorch port)")
    p.add_argument("--dataset", required=True, choices=sorted(DATASETS))
    p.add_argument("--data-root", default="data/eval_video")
    p.add_argument("--model-path", default=None)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--num-chunks", type=int, default=1)
    p.add_argument("--judge-model", default="gpt-3.5-turbo-0125")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the workers (default: the card)")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--skip-inference", action="store_true")
    p.add_argument("--skip-judge", action="store_true")
    args = p.parse_args(argv)

    info = DATASETS[args.dataset]
    gt = os.path.join(args.data_root, info["gt"])
    feats = os.path.join(args.data_root, info["features"])
    os.makedirs(args.output_dir, exist_ok=True)

    if not args.skip_inference:
        from . import model_video_qa as worker
        common = ["--video_dir", feats, "--gt_file", gt,
                  "--output_dir", args.output_dir,
                  "--num-chunks", str(args.num_chunks)]
        for flag, value in (("--model-path", args.model_path),
                            ("--device", args.device)):
            if value:
                common += [flag, value]
        if args.dry_run:
            common += ["--dry-run"]
        if args.num_chunks == 1:
            worker.run_inference(worker.make_parser().parse_args(
                common + ["--chunk-idx", "0"]))
        else:
            procs = [subprocess.Popen(
                [sys.executable, "-m",
                 "flash_vstream_tpu_torch.eval.model_video_qa", *common,
                 "--chunk-idx", str(i),
                 "--output_name", f"{args.num_chunks}_{i}"])
                for i in range(args.num_chunks)]
            for pr in procs:
                ret = pr.wait()
                if ret != 0:
                    print(f"worker exited with {ret}")

    if not args.skip_judge:
        from .gpt_judge import aggregate, judge_all
        from .scoring import load_predictions
        preds = load_predictions(args.output_dir, args.num_chunks)
        results = judge_all(preds, os.path.join(args.output_dir,
                                                "judge.json"),
                            model=args.judge_model)
        summary = aggregate(results)
        print(json.dumps(summary, indent=2))
        with open(os.path.join(args.output_dir, "result.json"), "w") as f:
            json.dump(summary, f, indent=2)


if __name__ == "__main__":
    main()
