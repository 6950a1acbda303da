#!/usr/bin/env python3
"""Write the video fixture the tests and chip_smoke.py read.

    python -m flash_vstream_tpu_torch.scripts.make_video_fixture \\
        [--out tests/data/video]

Writes, from a seeded smooth moving scene (16 frames of 224 x 224 px):
- `scene.mp4`: a single-track MJPEG mp4 at 8 fps, JPEG quality 90, written
  by the port's muxer (PIL encodes, as in the JAX package's);
- `scene_frames/%06d.jpg`: the same JPEG bytes as a frame directory (named
  apart from the mp4, so that `load_video("scene.mp4")` demuxes instead of
  taking the sibling-directory branch);
- `scene_expected.npz`: `frames` [16, 224, 224, 3] uint8 as the JAX
  package's decode_mjpeg gives them (PIL's decoder, called here as it
  calls it).

Needs PIL; run it where PIL is, and commit the output (a machine without
PIL cannot encode JPEG).
"""
import argparse
import os

import numpy as np

N_FRAMES, SIDE, FPS, QUALITY, SEED = 16, 224, 8.0, 90, 0


def scene(n=N_FRAMES, side=SIDE, seed=SEED):
    """n uint8 frames of a smooth scene: two seeded blobs of colour drifting
    over a slow gradient."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:side, 0:side].astype(np.float32) / side
    centres = rng.uniform(0.2, 0.8, size=(2, 2))
    drift = rng.uniform(-0.02, 0.02, size=(2, 2))
    colours = rng.uniform(60, 255, size=(2, 3))
    frames = []
    for t in range(n):
        img = np.stack([40 + 80 * x, 60 + 60 * y, 90 + 40 * (x + y) / 2], -1)
        for (cy, cx), (dy, dx), col in zip(centres, drift, colours):
            r2 = (y - cy - dy * t) ** 2 + (x - cx - dx * t) ** 2
            img += np.exp(-r2 / 0.02)[..., None] * (col - img) * 0.8
        frames.append(np.clip(img + 0.5, 0, 255).astype(np.uint8))
    return frames


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=os.path.join("tests", "data", "video"))
    args = p.parse_args(argv)
    import io

    from PIL import Image

    from ..preprocess.mp4 import demux_mjpeg, mux_mjpeg
    os.makedirs(os.path.join(args.out, "scene_frames"), exist_ok=True)
    src = scene()
    mp4 = os.path.join(args.out, "scene.mp4")
    mux_mjpeg(mp4, src, fps=FPS, quality=QUALITY)
    blobs, _ = demux_mjpeg(mp4)
    for i, blob in enumerate(blobs):
        with open(os.path.join(args.out, "scene_frames", f"{i:06d}.jpg"),
                  "wb") as f:
            f.write(blob)
    np.savez_compressed(os.path.join(args.out, "scene_expected.npz"),
                        frames=np.stack([np.asarray(Image.open(
                            io.BytesIO(b)).convert("RGB")) for b in blobs]))
    total = sum(os.path.getsize(os.path.join(dp, f))
                for dp, _, fs in os.walk(args.out) for f in fs)
    print(f"wrote {args.out}: {len(blobs)} frames, {total} bytes")


if __name__ == "__main__":
    main()
