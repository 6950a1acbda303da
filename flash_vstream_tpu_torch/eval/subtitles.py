"""Video-MME subtitle support.

Rebuild of get_subtitle (Flash-VStream-Qwen/inference_mcq_vqa.py:50-122)
without cv2: frame directories are extracted at a known fps (1 by default),
so sampled frame index i corresponds to time i/fps; we collect the subtitle
cues whose time span overlaps any sampled frame, deduplicated in order.

A copy of flash_vstream_tpu/eval/subtitles.py, which imports no
JAX, so that the port imports nothing of the JAX package.
"""
from __future__ import annotations

import os
import re
from typing import List, Optional, Sequence

_TIME = re.compile(
    r"(\d+):(\d+):(\d+)[,.](\d+)\s*-->\s*(\d+):(\d+):(\d+)[,.](\d+)")
_TAG = re.compile(r"<[^>]+>")


def parse_srt(text: str) -> List[dict]:
    """Parse .srt content into [{'start': s, 'end': s, 'text': str}]."""
    cues = []
    for block in re.split(r"\n\s*\n", text.strip()):
        lines = [l.strip() for l in block.splitlines() if l.strip()]
        if not lines:
            continue
        m = None
        ti = None
        for i, l in enumerate(lines):
            m = _TIME.search(l)
            if m:
                ti = i
                break
        if m is None:
            continue
        g = [int(x) for x in m.groups()]
        start = g[0] * 3600 + g[1] * 60 + g[2] + g[3] / 1000.0
        end = g[4] * 3600 + g[5] * 60 + g[6] + g[7] / 1000.0
        text_lines = lines[ti + 1:]
        txt = _TAG.sub("", " ".join(text_lines)).strip()
        if txt:
            cues.append({"start": start, "end": end, "text": txt})
    return cues


def subtitles_for_frames(cues: Sequence[dict], frame_times: Sequence[float]
                         ) -> str:
    """Join (deduplicated, in order) the cues overlapping any sampled frame
    time, mirroring the reference's sampled-frame alignment."""
    picked, seen = [], set()
    for t in frame_times:
        for c in cues:
            if c["start"] <= t <= c["end"] and c["text"] not in seen:
                seen.add(c["text"])
                picked.append(c["text"])
    return "\n".join(picked)


def get_subtitle(subtitle_dir: str, video_name: str,
                 frame_indices: Sequence[int], source_fps: float = 1.0
                 ) -> str:
    """Load <subtitle_dir>/<video_name>.srt and align to sampled frames."""
    path = os.path.join(subtitle_dir, video_name + ".srt")
    if not os.path.exists(path):
        return ""
    cues = parse_srt(open(path, encoding="utf-8", errors="replace").read())
    times = [i / source_fps for i in frame_indices]
    return subtitles_for_frames(cues, times)
