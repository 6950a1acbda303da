#!/usr/bin/env python3
"""Extract frames from videos to frame directories at a target fps.

The port's counterpart of scripts/extract_frames.py. Each entry of
--video_dir becomes `<frame_dir>/<name minus extension>/`, from the first
source that applies:
1. a directory: its files copied as `%06d.<ext>`;
2. an `ffmpeg` binary on PATH: `%06d.jpg` at --fps;
3. the port's `load_video` chain (preprocess/video.py: a registered
   decoder, a sibling frame directory, cv2, the MJPEG demuxer): `%06d.jpg`
   written by PIL at quality 90, as JAX writes them, or with
   `--format npy`, `%06d.npy` frames written by numpy, for machines without
   PIL (the port reads both).

    python -m flash_vstream_tpu_torch.scripts.extract_frames \\
        --video_dir VIDEOS --frame_dir FRAMES [--fps 1] [--format npy]
"""
import argparse
import os
import shutil
import subprocess
import sys
from multiprocessing.pool import ThreadPool

import numpy as np


def extract_one(src: str, dst: str, fps: float, fmt: str = "jpg") -> bool:
    """Frames of one video (file or directory) into `dst`; False on
    failure, with the reason on stderr."""
    os.makedirs(dst, exist_ok=True)
    if os.path.isdir(src):
        for i, name in enumerate(sorted(os.listdir(src))):
            ext = os.path.splitext(name)[1] if fmt == "npy" else ".jpg"
            shutil.copy(os.path.join(src, name),
                        os.path.join(dst, f"{i:06d}{ext}"))
        return True
    if fmt == "jpg" and shutil.which("ffmpeg"):
        cmd = ["ffmpeg", "-nostdin", "-loglevel", "error", "-i", src,
               "-vf", f"fps={fps}", "-q:v", "2",
               os.path.join(dst, "%06d.jpg")]
        return subprocess.run(cmd).returncode == 0
    from ..preprocess.video import load_video
    try:
        frames = load_video(src, fps=fps)
        for i, f in enumerate(frames):
            if fmt == "npy":
                np.save(os.path.join(dst, f"{i:06d}.npy"), np.asarray(f))
            else:
                from PIL import Image
                Image.fromarray(np.asarray(f)).save(
                    os.path.join(dst, f"{i:06d}.jpg"), quality=90)
        return True
    except (OSError, RuntimeError, ValueError, ImportError) as e:
        print(f"failed {src}: {e}", file=sys.stderr)
        return False


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--video_dir", required=True)
    p.add_argument("--frame_dir", required=True)
    p.add_argument("--fps", type=float, default=1.0)
    p.add_argument("--workers", type=int, default=16)
    p.add_argument("--format", choices=("jpg", "npy"), default="jpg",
                   help="frame files: JPEG through PIL or ffmpeg (as JAX), "
                        "or .npy through numpy (no PIL needed)")
    args = p.parse_args(argv)

    videos = sorted(os.listdir(args.video_dir))
    jobs = [(os.path.join(args.video_dir, v),
             os.path.join(args.frame_dir, os.path.splitext(v)[0]), args.fps,
             args.format)
            for v in videos]
    with ThreadPool(args.workers) as pool:
        ok = pool.starmap(extract_one, jobs)
    print(f"extracted {sum(ok)}/{len(jobs)} videos")
    return sum(ok)


if __name__ == "__main__":
    main()
