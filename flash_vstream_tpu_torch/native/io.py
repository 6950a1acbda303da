"""The host frame-ingestion library: JPEG decode + resize and a prefetching
loader, bound with ctypes.

Port of flash_vstream_tpu/native/io.py with the same names
(`native_available`, `decode_file`, `decode_batch`, `PrefetchLoader`) and
one more, `decode_bytes`, a decode from memory (MJPEG samples, HTTP image
bodies). The library's source is `csrc/vstream_io.cpp`, a JPEG decoder of
its own with no dependency (its partings from libjpeg are in that file's
header: sequential Huffman JPEG only, and a resize decodes at full size
first). It is built at first use, never at import, with the host C++
compiler (`$CXX`, else `g++`, else `c++`) into `build/flash_vstream_tpu_torch/`
at the repository root, named by a hash of the source, the flags, the
compiler's version and the machine. A build failure raises with the
compiler's output; no call decodes by another route.

A valid JPEG of a coding the decoder does not implement (progressive,
arithmetic-coded, lossless, hierarchical, 12-bit, CMYK, sampling above 2x2)
is refused by the library and then decoded by PIL where PIL is installed
(the library's bilinear pass resizes it), else raises IOError naming the
reason. An image of more than MAX_PIXELS pixels raises IOError before
anything is allocated for it.
"""
from __future__ import annotations

import ctypes
import hashlib
import io
import os
import platform
import shutil
import struct
import subprocess
import threading
from functools import lru_cache
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().with_name("csrc") / "vstream_io.cpp"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "flash_vstream_tpu_torch")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread")
MAX_PIXELS = 2 * 89_478_485   # PIL's decompression-bomb limit; kMaxPixels
REFUSED = 2                   # the library's code for a coding it lacks

_U8P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "vio_error": ([], ctypes.c_char_p),
    "vio_decode_file": ([ctypes.c_char_p, ctypes.c_int, ctypes.c_int, _U8P],
                        ctypes.c_int),
    "vio_decode_mem": ([ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_int, _U8P], ctypes.c_int),
    "vio_decode_batch": ([ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, _U8P,
                          ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
    "vio_resize": ([_U8P, ctypes.c_int, ctypes.c_int, _U8P, ctypes.c_int,
                    ctypes.c_int], ctypes.c_int),
    "vio_loader_create": ([ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int],
                          ctypes.c_void_p),
    "vio_loader_next": ([ctypes.c_void_p, _U8P], ctypes.c_int),
    "vio_loader_destroy": ([ctypes.c_void_p], None),
}

_LIB = None          # the loaded library, once per process
_LIB_LOCK = threading.Lock()


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler to build the video I/O library "
                           "(set CXX, or put g++ on PATH)")
    return cxx


@lru_cache(maxsize=None)
def _toolchain(cxx: str) -> str:
    """The compiler's path and version and the machine, so that a build
    directory carried to another host is rebuilt there, not loaded."""
    try:
        version = subprocess.run([cxx, "--version"], capture_output=True,
                                 text=True).stdout
    except OSError as e:
        raise RuntimeError(f"cannot run the C++ compiler {cxx}: {e}") from e
    return f"{cxx}\n{version}\n{platform.machine()}"


def library_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Where the library for `source` lives (built or not)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_toolchain(_compiler()).encode())
    h.update(Path(source).read_bytes())
    return Path(build_dir) / f"libvstream_io_{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Compile `source` unless a library for it exists. Processes that
    build at once each write a file of their own and rename it into place,
    so a reader never sees half a library."""
    out = library_path(source, build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        f".tmp")
    cxx = _compiler()
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the video I/O library with {cxx} "
                           f"failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """Build `source` if need be and load it with its C signatures."""
    lib = ctypes.CDLL(str(build(source, build_dir)))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def library() -> ctypes.CDLL:
    """The library of `csrc/vstream_io.cpp`, built on first use and loaded
    once, whichever thread asks first."""
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                _LIB = load()
    return _LIB


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _reason(lib) -> str:
    return lib.vio_error().decode(errors="replace")


def _decode_refused(blob: bytes, out_h: int, out_w: int, name: str,
                    reason: str) -> np.ndarray:
    """A JPEG the library refused for its coding, decoded by PIL (imported
    only here) and resized by the library's bilinear pass."""
    try:
        from PIL import Image
    except ImportError:
        raise IOError(f"{name}: {reason} (PIL, which decodes such files, is "
                      f"not installed)") from None
    try:
        with Image.open(io.BytesIO(blob)) as im:
            full = np.ascontiguousarray(im.convert("RGB"))
    except (OSError, ValueError, Image.DecompressionBombError) as e:
        raise IOError(f"{name}: {reason}; PIL: {e}") from None
    if full.shape[:2] == (out_h, out_w):
        return full
    out = np.empty((out_h, out_w, 3), np.uint8)
    lib = library()
    if lib.vio_resize(_ptr(full), full.shape[0], full.shape[1], _ptr(out),
                      out_h, out_w) != 0:
        raise IOError(f"{name}: {_reason(lib)}")
    return out


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def decode_file(path: str, out_h: int, out_w: int) -> np.ndarray:
    """Decode+resize one JPEG file to uint8 RGB [out_h, out_w, 3]."""
    lib = library()
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.vio_decode_file(os.fsencode(path), out_h, out_w, _ptr(out))
    if rc == REFUSED:
        return _decode_refused(_read(path), out_h, out_w, path, _reason(lib))
    if rc != 0:
        raise IOError(f"{path}: {_reason(lib)}")
    return out


def decode_batch(paths: Sequence[str], out_h: int, out_w: int) -> np.ndarray:
    """Decode+resize a batch of JPEG files to uint8 [n, out_h, out_w, 3];
    a file that fails to decode leaves its slot zeroed."""
    lib = library()
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    codes = np.zeros(n, np.intc)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.vio_decode_batch(arr, n, out_h, out_w, _ptr(out),
                         codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    for i in np.flatnonzero(codes == REFUSED):
        try:
            out[i] = _decode_refused(_read(paths[i]), out_h, out_w, paths[i],
                                     "refused by the decoder")
        except IOError:
            pass                                  # the slot stays zeroed
    return out


def jpeg_hw(data: bytes) -> tuple:
    """(height, width) from a JPEG's SOF marker, in Python (no decode, no
    library). Raises IOError past MAX_PIXELS."""
    if data[:2] != b"\xff\xd8":
        raise IOError("not a JPEG (no SOI marker)")
    off = 2
    while off + 4 <= len(data):
        if data[off] != 0xFF:
            off += 1
            continue
        marker = data[off + 1]
        if marker == 0xFF:
            off += 1
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            off += 2
            continue
        if marker in (0xD9, 0xDA):
            break
        size = struct.unpack_from(">H", data, off + 2)[0]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            h, w = struct.unpack_from(">HH", data, off + 5)
            if h * w > MAX_PIXELS:
                raise IOError(f"{w}x{h} is more than the {MAX_PIXELS} "
                              f"pixels a JPEG may have")
            return h, w
        off += 2 + size
    raise IOError("no SOF marker in the JPEG")


def decode_bytes(blob: bytes, out_h: Optional[int] = None,
                 out_w: Optional[int] = None,
                 name: str = "JPEG bytes") -> np.ndarray:
    """Decode a JPEG held in memory to uint8 RGB [H, W, 3]: at its own size
    when no target is given, else resized to (out_h, out_w). `name` says
    where the bytes came from in the error."""
    lib = library()
    blob = bytes(blob)
    if out_h is None or out_w is None:
        try:
            h, w = jpeg_hw(blob)
        except (IOError, struct.error) as e:
            raise IOError(f"{name}: {e}") from None
        out_h = h if out_h is None else out_h
        out_w = w if out_w is None else out_w
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.vio_decode_mem(blob, len(blob), out_h, out_w, _ptr(out))
    if rc == REFUSED:
        return _decode_refused(blob, out_h, out_w, name, _reason(lib))
    if rc != 0:
        raise IOError(f"{name}: {_reason(lib)}")
    return out


class PrefetchLoader:
    """Background-thread frame loader: decode overlaps device compute.

    Iterates uint8 RGB frames [out_h, out_w, 3] in path order, decoded in a
    C++ worker thread up to `prefetch_depth` frames ahead of consumption.
    A frame that fails to decode comes out zeroed; one the library refuses
    for its coding is decoded by PIL in the consuming thread.
    """

    def __init__(self, paths: Sequence[str], out_h: int, out_w: int,
                 prefetch_depth: int = 8):
        self._handle = None
        self.paths = list(paths)
        self.out_h, self.out_w = out_h, out_w
        self._lib = library()
        self._keepalive = (ctypes.c_char_p * len(self.paths))(
            *[os.fsencode(p) for p in self.paths])
        self._next = 0
        self._handle = self._lib.vio_loader_create(
            self._keepalive, len(self.paths), out_h, out_w, prefetch_depth)
        if not self._handle:
            self._handle = None
            raise RuntimeError(f"cannot start the loader: "
                               f"{_reason(self._lib)}")

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._handle is None:
            raise StopIteration
        out = np.empty((self.out_h, self.out_w, 3), np.uint8)
        rc = self._lib.vio_loader_next(self._handle, _ptr(out))
        if rc == 0:
            self.close()
            raise StopIteration
        path = self.paths[self._next]
        self._next += 1
        if rc == -REFUSED:
            try:
                return _decode_refused(_read(path), self.out_h, self.out_w,
                                       path, "refused by the decoder")
            except IOError:
                pass                              # the frame stays zeroed
        return out

    def close(self):
        if self._handle is not None:
            self._lib.vio_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
