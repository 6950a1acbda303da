"""Pure-Python MP4 (ISO-BMFF) demux/mux for Motion-JPEG video tracks.

Port of flash_vstream_tpu/preprocess/mp4.py:34-283 with the same box walk
(stsc, stsz, stco/co64), fps rule and `max_frames` spread. MJPEG-in-mp4
(the format OpenCV's 'MJPG' writer and many capture pipelines emit) needs
only box parsing and a JPEG decode:

- demux_mjpeg(path): sample table walk -> JPEG bytes
- decode_mjpeg(path, ...): demux + decode to uint8 HWC frames, through the
  port's own JPEG decoder (native/io.py `decode_bytes`; JAX decodes with
  PIL)
- mux_mjpeg(path, frames, fps): a minimal single-track writer; a frame may
  be an array (encoded by PIL, imported only then, as JAX does) or JPEG
  bytes, written as they are (for machines without PIL)

H.264/H.265 content takes load_video's cv2 or ffmpeg branches, or a sibling
frame directory (scripts/extract_frames.py).
"""
from __future__ import annotations

import io
import struct
from typing import List, Optional, Tuple

import numpy as np

_JPEG_SOI = b"\xff\xd8"


# ---------------------------------------------------------------------------
# Demux
# ---------------------------------------------------------------------------

def _boxes(buf: memoryview, start: int, end: int):
    """Yield (type, body_start, body_end) for boxes in [start, end)."""
    off = start
    while off + 8 <= end:
        size = struct.unpack_from(">I", buf, off)[0]
        typ = bytes(buf[off + 4:off + 8])
        hdr = 8
        if size == 1:
            size = struct.unpack_from(">Q", buf, off + 8)[0]
            hdr = 16
        elif size == 0:
            size = end - off
        if size < hdr:
            break
        yield typ, off + hdr, off + size
        off += size


def _find(buf, start, end, *path):
    """Descend a box path; returns (body_start, body_end) or None."""
    if not path:
        return start, end
    for typ, s, e in _boxes(buf, start, end):
        if typ == path[0]:
            return _find(buf, s, e, *path[1:])
    return None


def _u32s(buf, off, n):
    return struct.unpack_from(f">{n}I", buf, off)


class Mp4Track:
    def __init__(self, sizes, offsets, codec, timescale, duration, n):
        self.sample_sizes = sizes          # [n]
        self.sample_offsets = offsets      # [n] absolute file offsets
        self.codec = codec
        self.timescale = timescale
        self.duration = duration
        self.n_samples = n

    @property
    def fps(self) -> float:
        if self.duration and self.n_samples:
            return self.n_samples * self.timescale / self.duration
        return 1.0


def _parse_stbl(buf, stbl_s, stbl_e) -> Optional[Tuple]:
    stsd = _find(buf, stbl_s, stbl_e, b"stsd")
    stsz = _find(buf, stbl_s, stbl_e, b"stsz")
    stsc = _find(buf, stbl_s, stbl_e, b"stsc")
    stco = _find(buf, stbl_s, stbl_e, b"stco")
    co64 = _find(buf, stbl_s, stbl_e, b"co64")
    if not (stsd and stsz and stsc and (stco or co64)):
        return None
    # codec fourcc: first sample entry in stsd
    s, e = stsd
    codec = b""
    for typ, bs, be in _boxes(buf, s + 8, e):
        codec = typ
        break
    # stsz: version/flags u32, sample_size u32, count u32
    s, _ = stsz
    fixed, count = _u32s(buf, s + 4, 2)
    if fixed:
        sizes = [fixed] * count
    else:
        sizes = list(_u32s(buf, s + 12, count))
    # chunk offsets
    if stco:
        s, _ = stco
        n_chunks = _u32s(buf, s + 4, 1)[0]
        chunk_offs = list(_u32s(buf, s + 8, n_chunks))
    else:
        s, _ = co64
        n_chunks = _u32s(buf, s + 4, 1)[0]
        chunk_offs = list(struct.unpack_from(f">{n_chunks}Q", buf, s + 8))
    # stsc: entries (first_chunk, samples_per_chunk, desc_idx)
    s, _ = stsc
    n_ent = _u32s(buf, s + 4, 1)[0]
    ents = [_u32s(buf, s + 8 + 12 * i, 3) for i in range(n_ent)]
    # expand sample -> absolute offset
    offsets: List[int] = []
    si = 0
    for ei, (first, per_chunk, _d) in enumerate(ents):
        last = ents[ei + 1][0] - 1 if ei + 1 < len(ents) else len(chunk_offs)
        for ci in range(first - 1, last):
            off = chunk_offs[ci]
            for _ in range(per_chunk):
                if si >= len(sizes):
                    break
                offsets.append(off)
                off += sizes[si]
                si += 1
    return sizes, offsets, codec


def parse_mp4(path: str, data: Optional[bytes] = None) -> Mp4Track:
    """Parse the first video track's sample table."""
    if data is None:
        with open(path, "rb") as f:
            data = f.read()
    buf = memoryview(data)
    moov = _find(buf, 0, len(data), b"moov")
    if moov is None:
        raise ValueError(f"{path}: no moov box (not an MP4?)")
    for typ, s, e in _boxes(buf, *moov):
        if typ != b"trak":
            continue
        mdia = _find(buf, s, e, b"mdia")
        if mdia is None:
            continue
        hdlr = _find(buf, *mdia, b"hdlr")
        if hdlr is None or bytes(buf[hdlr[0] + 8:hdlr[0] + 12]) != b"vide":
            continue
        mdhd = _find(buf, *mdia, b"mdhd")
        timescale, duration = 0, 0
        if mdhd:
            ver = buf[mdhd[0]]
            if ver == 1:
                timescale = struct.unpack_from(">I", buf, mdhd[0] + 20)[0]
                duration = struct.unpack_from(">Q", buf, mdhd[0] + 24)[0]
            else:
                timescale, duration = _u32s(buf, mdhd[0] + 12, 2)
        stbl = _find(buf, *mdia, b"minf", b"stbl")
        if stbl is None:
            continue
        parsed = _parse_stbl(buf, *stbl)
        if parsed is None:
            continue
        sizes, offsets, codec = parsed
        return Mp4Track(sizes, offsets, codec, timescale, duration,
                        len(sizes))
    raise ValueError(f"{path}: no parseable video track")


def demux_mjpeg(path: str) -> Tuple[List[bytes], float]:
    """Extract JPEG sample payloads from an MJPEG-in-mp4 file.

    Returns (jpeg_blobs, fps). Raises ValueError when the track's samples
    are not JPEG (e.g. H.264) — callers fall back to extract-frames-first.
    """
    with open(path, "rb") as f:
        data = f.read()
    track = parse_mp4(path, data)
    blobs = []
    for off, size in zip(track.sample_offsets, track.sample_sizes):
        blob = data[off:off + size]
        if not blob.startswith(_JPEG_SOI):
            raise ValueError(
                f"{path}: video samples are {track.codec.decode(errors='replace')}"
                f", not JPEG. Pre-extract frames "
                f"(flash_vstream_tpu_torch/scripts/extract_frames.py) or "
                f"place a sibling frame directory next to the file.")
        blobs.append(blob)
    return blobs, track.fps


def decode_mjpeg(path: str, fps: Optional[float] = None,
                 max_frames: Optional[int] = None) -> List[np.ndarray]:
    """Demux + JPEG-decode to uint8 HWC frames, subsampled to `fps`."""
    blobs, src_fps = demux_mjpeg(path)
    if fps and src_fps > fps:
        step = max(int(round(src_fps / fps)), 1)
        blobs = blobs[::step]
    if max_frames is not None and len(blobs) > max_frames:
        idx = np.linspace(0, len(blobs) - 1, max_frames).round().astype(int)
        blobs = [blobs[i] for i in idx]
    from ..native.io import decode_bytes
    return [decode_bytes(blob, name=f"{path} sample {i}")
            for i, blob in enumerate(blobs)]


# ---------------------------------------------------------------------------
# Mux (minimal single-track MJPEG writer)
# ---------------------------------------------------------------------------

def _box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + typ + payload


def _full(typ: bytes, payload: bytes, version=0, flags=0) -> bytes:
    return _box(typ, struct.pack(">I", (version << 24) | flags) + payload)


def mux_mjpeg(path: str, frames, fps: float = 1.0, quality: int = 90):
    """Write frames as a single-video-track MJPEG mp4. A frame is a uint8
    HWC array (JPEG-encoded by PIL at `quality`) or the bytes of a JPEG
    (written as they are)."""
    blobs, size = [], None
    for f in frames:
        if isinstance(f, (bytes, bytearray)):
            blob = bytes(f)
            if size is None:
                from ..native.io import jpeg_hw
                size = jpeg_hw(blob)
        else:
            from PIL import Image
            b = io.BytesIO()
            Image.fromarray(np.asarray(f)).save(b, format="JPEG",
                                                quality=quality)
            blob = b.getvalue()
            if size is None:
                size = np.asarray(f).shape[:2]
        blobs.append(blob)
    n = len(blobs)
    h, w = size
    timescale = max(int(round(fps * 1000)), 1)
    sample_dur = 1000
    duration = n * sample_dur

    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2mp41")
    mdat_payload = b"".join(blobs)
    mdat = _box(b"mdat", mdat_payload)
    # sample offsets: after ftyp + mdat header
    base = len(ftyp) + 8
    offsets, off = [], base
    for b in blobs:
        offsets.append(off)
        off += len(b)

    jpeg_entry = _box(b"jpeg", b"\x00" * 6 + struct.pack(">H", 1)
                      + b"\x00" * 16
                      + struct.pack(">HH", w, h)
                      + struct.pack(">II", 0x00480000, 0x00480000)
                      + b"\x00" * 4 + struct.pack(">H", 1)
                      + b"\x00" * 32
                      + struct.pack(">Hh", 24, -1))
    stsd = _full(b"stsd", struct.pack(">I", 1) + jpeg_entry)
    stts = _full(b"stts", struct.pack(">III", 1, n, sample_dur))
    stsc = _full(b"stsc", struct.pack(">IIII", 1, 1, n, 1))
    stsz = _full(b"stsz", struct.pack(">II", 0, n)
                 + b"".join(struct.pack(">I", len(b)) for b in blobs))
    stco = _full(b"stco", struct.pack(">I", 1)
                 + struct.pack(">I", offsets[0]))
    stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco)
    url = _full(b"url ", b"", flags=1)
    dref = _full(b"dref", struct.pack(">I", 1) + url)
    dinf = _box(b"dinf", dref)
    vmhd = _full(b"vmhd", b"\x00" * 8, flags=1)
    minf = _box(b"minf", vmhd + dinf + stbl)
    hdlr = _full(b"hdlr", b"\x00" * 4 + b"vide" + b"\x00" * 12 + b"vide\x00")
    mdhd = _full(b"mdhd", struct.pack(">IIIIHH", 0, 0, timescale, duration,
                                      0x55C4, 0))
    mdia = _box(b"mdia", mdhd + hdlr + minf)
    tkhd = _full(b"tkhd", struct.pack(">IIIII", 0, 0, 1, 0, duration)
                 + b"\x00" * 16
                 + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                               0x40000000)
                 + struct.pack(">II", w << 16, h << 16), flags=7)
    trak = _box(b"trak", tkhd + mdia)
    mvhd = _full(b"mvhd", struct.pack(">IIII", 0, 0, timescale, duration)
                 + struct.pack(">IH", 0x10000, 0x0100) + b"\x00" * 10
                 + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                               0x40000000)
                 + b"\x00" * 24 + struct.pack(">I", 2))
    moov = _box(b"moov", mvhd + trak)
    with open(path, "wb") as f:
        f.write(ftyp + mdat + moov)
