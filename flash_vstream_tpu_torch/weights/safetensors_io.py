"""Read and write the safetensors format with torch alone.

A `.safetensors` file is an 8-byte little-endian header length N, N bytes
of JSON ({name: {"dtype", "shape", "data_offsets": [begin, end]}}, plus an
optional "__metadata__" of strings), then the tensors' raw little-endian
bytes, offsets counted from the end of the header. The port reads and
writes it itself because the card's machine has no `safetensors` package
(and numpy has no bfloat16).

`load_file` maps the file (`mmap`, copy-on-write) and returns tensors that
are views of the mapping: nothing is read until a tensor is touched, and a
caller that copies each tensor where it belongs (weights/convert.py stacks
the layers on the target device) never holds a second host copy. A view
whose offset is not a multiple of its element size (a file from a writer
that does not align) is copied.
"""
from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Optional

import torch

DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "I64": torch.int64, "I32": torch.int32, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
NAMES = {v: k for k, v in DTYPES.items()}
_ALIGN = 8        # the header is padded so that the data starts 8-aligned


def _header(f) -> tuple:
    raw = f.read(8)
    if len(raw) != 8:
        raise ValueError(f"{f.name}: not a safetensors file (too short)")
    (n,) = struct.unpack("<Q", raw)
    header = json.loads(f.read(n))
    return header, 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one `.safetensors` file, as CPU tensors that view a
    copy-on-write mapping of the file (writes to them never reach it)."""
    with open(path, "rb") as f:
        header, start = _header(f)
        size = os.fstat(f.fileno()).st_size
        buf = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
               if size > start else None)
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{meta['dtype']}, not one of {sorted(DTYPES)}")
        shape = tuple(meta["shape"])
        a, b = meta["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        numel = 1
        for s in shape:
            numel *= s
        if b - a != numel * itemsize or start + b > size:
            raise ValueError(f"{path}: tensor {name!r} of shape {shape} "
                             f"{meta['dtype']} has data_offsets {[a, b]}")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        raw = torch.frombuffer(buf, dtype=torch.uint8, count=b - a,
                               offset=start + a)
        if (start + a) % itemsize:
            raw = raw.clone()
        out[name] = raw.view(dtype).reshape(shape)
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> int:
    """Write `tensors` (any device; each is copied to the host one at a
    time) to `path`; returns the bytes written. The tensors are laid out by
    element size, largest first, then by name, so every one starts at a
    multiple of its element size, as the `safetensors` package lays them."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in NAMES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}, not one "
                             f"of {sorted(map(str, NAMES))}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-(8 + len(blob)) % _ALIGN)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach()
            if t.numel():
                host = t.to("cpu").contiguous().reshape(-1)
                f.write(memoryview(host.view(torch.uint8).numpy()))
    return 8 + len(blob) + offset
