"""Host-side video frame sources.

Port of flash_vstream_tpu/preprocess/video.py:24-204 (numpy only):
`FrameSource`, `SyntheticSource`, a decoder registry
(`register_video_decoder`), JPEG/PNG frame directories (`load_frame_dir`,
PIL imported when a directory is read), and the probes training uses to
bucket items by resolution and length. All sources yield uint8 HWC frames.

Not ported: the native JPEG decoder (PIL decodes frame directories), and the
mp4/cv2/ffmpeg branches of `load_video`, which raise (ROADMAP A1): register a
decoder for such files instead.
"""
from __future__ import annotations

import os
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

_VIDEO_DECODERS: dict = {}
_FRAME_EXTS = (".jpg", ".jpeg", ".png")


def register_video_decoder(ext: str, fn: Callable[[str, float], Sequence]):
    """Decode files ending in `.ext` with fn(path, fps) -> frames."""
    _VIDEO_DECODERS[ext.lower()] = fn


class FrameSource:
    """Iterable of uint8 HWC frames with known fps."""

    def __init__(self, frames: Sequence[np.ndarray], fps: float = 1.0):
        self._frames = list(frames)
        self.fps = fps

    def __len__(self):
        return len(self._frames)

    def __getitem__(self, i):
        return self._frames[i]

    def __iter__(self) -> Iterator[np.ndarray]:
        return iter(self._frames)


class SyntheticSource(FrameSource):
    """Deterministic synthetic frames (a moving random texture)."""

    def __init__(self, n_frames: int, height: int = 224, width: int = 224,
                 fps: float = 1.0, seed: int = 0):
        rng = np.random.default_rng(seed)
        base = rng.integers(0, 255, size=(height, width, 3), dtype=np.uint8)
        frames = []
        for t in range(n_frames):
            f = np.roll(base, shift=3 * t, axis=1).copy()
            f[:, :, 0] = (f[:, :, 0].astype(np.int32) + 5 * t) % 256
            frames.append(f)
        super().__init__(frames, fps)


def _frame_names(path: str):
    return sorted(n for n in os.listdir(path)
                  if n.lower().endswith(_FRAME_EXTS))


def load_frame_dir(path: str, fps: float = 1.0, source_fps: float = 1.0,
                   max_frames: Optional[int] = None) -> FrameSource:
    """A directory of extracted frames (sorted by name), subsampled from
    source_fps to fps, at most `max_frames` spread evenly."""
    names = _frame_names(path)[::max(int(round(source_fps / fps)), 1)]
    if max_frames is not None and len(names) > max_frames:
        idx = np.linspace(0, len(names) - 1, max_frames).round().astype(int)
        names = [names[i] for i in idx]
    from PIL import Image
    frames = [np.asarray(Image.open(os.path.join(path, n)).convert("RGB"))
              for n in names]
    return FrameSource(frames, fps)


def probe_video_hw(path: str) -> tuple:
    """(height, width) of a video's frames: a frame directory's first image
    header, else one decoded frame."""
    if os.path.isdir(path):
        names = _frame_names(path)
        if not names:
            raise FileNotFoundError(f"no frames in {path}")
        from PIL import Image
        with Image.open(os.path.join(path, names[0])) as im:
            w, h = im.size
        return h, w
    frame = load_video(path, max_frames=1)[0]
    return tuple(np.asarray(frame).shape[:2])


def probe_video_len(path: str) -> int:
    """Frame count: a frame directory's file count, else a full decode."""
    if os.path.isdir(path):
        return len(_frame_names(path))
    return len(load_video(path))


def load_video(path: str, fps: float = 1.0,
               max_frames: Optional[int] = None) -> FrameSource:
    """Frames of a frame directory or of a file with a registered decoder,
    at most `max_frames` spread evenly."""
    if os.path.isdir(path):
        return load_frame_dir(path, fps=fps, max_frames=max_frames)
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    if ext in _VIDEO_DECODERS:
        frames = _VIDEO_DECODERS[ext](path, fps)
        if max_frames is not None and len(frames) > max_frames:
            idx = np.linspace(0, len(frames) - 1,
                              max_frames).round().astype(int)
            frames = [frames[i] for i in idx]
        return FrameSource(list(frames), fps)
    raise NotImplementedError(
        f"no decoder registered for .{ext}; container decoding (mp4, cv2, "
        f"ffmpeg) is not ported yet: ROADMAP A1. Extract frames to a "
        f"directory or register_video_decoder()")
