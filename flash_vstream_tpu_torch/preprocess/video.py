"""Host-side video frame sources.

Port of flash_vstream_tpu/preprocess/video.py (numpy only):
`FrameSource`, `SyntheticSource`, a decoder registry
(`register_video_decoder`), frame directories (`load_frame_dir`; unlike
JAX, `.npy` frames too, read with numpy), `load_video`'s container chain,
and the probes training uses to bucket items by resolution and length.
All sources yield uint8 HWC frames.

JPEG frames decode through the port's own library (native/io.py, built at
first use); PNG frames through PIL, imported only for them. The probes read
a JPEG's SOF marker and a PNG's IHDR chunk in Python, with no decode.
"""
from __future__ import annotations

import os
import shutil
import struct
import subprocess
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

_VIDEO_DECODERS: dict = {}
_FRAME_EXTS = (".jpg", ".jpeg", ".png", ".npy")
_JPEG_EXTS = (".jpg", ".jpeg")


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


def image_hw(path: str) -> tuple:
    """(height, width) of an image file from its header: a JPEG's SOF
    marker, a PNG's IHDR chunk, a `.npy` frame's array header; any other
    format through PIL (imported only then)."""
    low = path.lower()
    if low.endswith(".npy"):
        return tuple(np.load(path, mmap_mode="r").shape[:2])
    with open(path, "rb") as f:
        head = f.read(64 * 1024)
        if head[:2] == b"\xff\xd8":
            from ..native.io import jpeg_hw
            try:
                return jpeg_hw(head)
            except (IOError, struct.error):   # the SOF lies further on
                return jpeg_hw(head + f.read())
    if head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR":
        w, h = struct.unpack_from(">II", head, 16)
        return h, w
    from PIL import Image
    with Image.open(path) as im:
        w, h = im.size
    return h, w


def read_frame(path: str) -> np.ndarray:
    """One uint8 [H, W, 3] frame at its own size: a `.npy` file with numpy,
    a JPEG through the port's decoder, any other image file decoded by PIL
    (imported only then) as RGB."""
    low = path.lower()
    if low.endswith(".npy"):
        return np.load(path)
    if low.endswith(_JPEG_EXTS):
        from ..native import io as vio
        with open(path, "rb") as f:
            return vio.decode_bytes(f.read(), name=path)
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def load_frame_dir(path: str, fps: float = 1.0, source_fps: float = 1.0,
                   max_frames: Optional[int] = None,
                   resize_hw: Optional[tuple] = None) -> FrameSource:
    """A directory of extracted frames (sorted by name), subsampled from
    source_fps to fps, at most `max_frames` spread evenly. As in JAX, JPEG
    frames decode in one batch at the first frame's size, or at `resize_hw`
    (fused decode + bilinear resize; a frame that fails to decode comes out
    zeroed); `resize_hw` takes JPEG frames only."""
    names = _frame_names(path)[::max(int(round(source_fps / fps)), 1)]
    if max_frames is not None and len(names) > max_frames:
        idx = np.linspace(0, len(names) - 1, max_frames).round().astype(int)
        names = [names[i] for i in idx]
    paths = [os.path.join(path, n) for n in names]
    if resize_hw is not None:
        if not all(p.lower().endswith(_JPEG_EXTS) for p in paths):
            raise ValueError(f"{path}: resize_hw decodes JPEG frames only")
        from ..native import io as vio
        frames = list(vio.decode_batch(paths, *resize_hw)) if paths else []
    elif paths and paths[0].lower().endswith(_JPEG_EXTS):
        from ..native import io as vio
        frames = list(vio.decode_batch(paths, *image_hw(paths[0])))
    else:
        frames = [read_frame(p) for p in paths]
    return FrameSource(frames, fps)


def probe_video_hw(path: str) -> tuple:
    """(height, width) of a video's frames: a frame directory's first
    frame's header, else one decoded frame."""
    if os.path.isdir(path):
        names = _frame_names(path)
        if not names:
            raise FileNotFoundError(f"no frames in {path}")
        return image_hw(os.path.join(path, names[0]))
    frame = load_video(path, max_frames=1)[0]
    return tuple(np.asarray(frame).shape[:2])


def probe_video_len(path: str) -> int:
    """Frame count without decoding pixels: a frame directory counts files;
    an mp4 its sibling frame directory, else its sample table; else cv2's
    container header; else a full decode."""
    if os.path.isdir(path):
        return len(_frame_names(path))
    if os.path.splitext(path)[1].lower().lstrip(".") in ("mp4", "mov",
                                                         "m4v"):
        sibling = os.path.splitext(path)[0]
        if os.path.isdir(sibling):
            return probe_video_len(sibling)
        from .mp4 import parse_mp4
        try:
            return parse_mp4(path).n_samples
        except (ValueError, struct.error, IndexError, OSError):
            pass
    try:                    # container header via cv2, no pixel decode
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        cap = cv2.VideoCapture(path)
        try:
            if cap.isOpened():
                n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
                if n > 0:
                    return n
        finally:
            cap.release()
    return len(load_video(path))


def load_video(path: str, fps: float = 1.0,
               max_frames: Optional[int] = None) -> FrameSource:
    """Frames of a video file or frame directory, at most `max_frames`
    spread evenly.

    A video file is read by the first of JAX's chain that applies:
    1. a registered decoder for the extension (register_video_decoder),
    2. a sibling frame directory (the path minus its extension),
    3. cv2's in-process decode (any codec its FFmpeg backend reads), when
       cv2 is importable and opens the file,
    4. the pure-Python MJPEG-in-mp4 demuxer (preprocess/mp4.py) and the
       port's JPEG decoder,
    5. an `ffmpeg` binary on PATH, extracting to the sibling directory at
       1 fps (cached for later loads).
    Other content raises RuntimeError with instructions.
    """
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
    if ext in ("mp4", "mov", "m4v", "avi", "mkv", "webm"):
        sibling = os.path.splitext(path)[0]
        if os.path.isdir(sibling):
            return load_frame_dir(sibling, fps=fps, max_frames=max_frames)
        frames = _decode_cv2(path, fps=fps, max_frames=max_frames)
        if frames is not None:
            return FrameSource(frames, fps)
        if ext not in ("mp4", "mov", "m4v"):
            raise RuntimeError(
                f"{path}: .{ext} needs OpenCV (cv2) or a registered decoder.")
        from .mp4 import decode_mjpeg
        try:
            frames = decode_mjpeg(path, fps=fps, max_frames=max_frames)
        except ValueError as demux_err:
            # not MJPEG (H.264/H.265): extract to the sibling directory at
            # the canonical 1 fps, so the cache serves any later fps
            if _extract_frames_ffmpeg(path, sibling, fps=1.0):
                return load_frame_dir(sibling, fps=fps,
                                      max_frames=max_frames)
            raise RuntimeError(
                f"{path}: not MJPEG and no ffmpeg on PATH to auto-extract. "
                f"Pre-extract frames to '{sibling}/' "
                f"(scripts/extract_frames.py) or register_video_decoder()."
            ) from demux_err
        return FrameSource(frames, fps)
    raise RuntimeError(
        f"No decoder registered for .{ext}; extract frames to a directory "
        "(scripts/extract_frames.py) or register_video_decoder().")


def _decode_cv2(path: str, fps: float = 1.0, max_frames: Optional[int] = None
                ) -> Optional[List[np.ndarray]]:
    """In-process video decode via OpenCV's FFmpeg backend: the container
    stream subsampled to the target fps with cheap ``grab()`` skips,
    decoding only the kept frames. None when cv2 is absent or cannot open
    the file, so the caller falls through to the demuxer and ffmpeg."""
    try:
        import cv2
    except ImportError:
        return None
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        return None
    try:
        src_fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
        # headers sometimes lie (0/NaN); treat those as already at target fps
        step = max(int(round(src_fps / fps)), 1) if src_fps > 0 else 1
        frames: List[np.ndarray] = []
        i = 0
        while True:
            if i % step == 0:
                ret, frame = cap.read()        # decode kept frames
                if not ret:
                    break
                frames.append(frame[:, :, ::-1].copy())   # BGR -> RGB
            elif not cap.grab():               # skip without pixel decode
                break
            i += 1
        if not frames:
            return None
        if max_frames is not None and len(frames) > max_frames:
            idx = np.linspace(0, len(frames) - 1,
                              max_frames).round().astype(int)
            frames = [frames[j] for j in idx]
        return frames
    finally:
        cap.release()


def _extract_frames_ffmpeg(path: str, out_dir: str,
                           fps: float = 1.0) -> bool:
    """Extract frames with the ffmpeg binary, if present, into the sibling
    directory load_video already looks for, so the extraction serves every
    later load of the same file."""
    if not shutil.which("ffmpeg"):
        return False
    tmp = out_dir + ".extracting"
    os.makedirs(tmp, exist_ok=True)
    cmd = ["ffmpeg", "-nostdin", "-loglevel", "error", "-i", path,
           "-vf", f"fps={fps}", "-q:v", "2",
           os.path.join(tmp, "%06d.jpg")]
    if subprocess.run(cmd).returncode != 0 or not os.listdir(tmp):
        shutil.rmtree(tmp, ignore_errors=True)
        return False
    os.replace(tmp, out_dir)   # atomic publish: readers never see partials
    return True
