"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every `csrc/*.cu` file compiles to an object in its own nvcc process, all
started together, and the objects link into one shared library with a plain
C interface (no PyTorch headers, so the build takes seconds). The library
lands in `build/flash_vstream_tpu_torch/` at the repository root, named by a
hash of the sources (headers included) and flags, so a changed source builds
anew and an unchanged one loads at once. The build runs at first use, never
at import: the CPU tests import every module on machines without nvcc.

Each C entry returns the `cudaGetLastError()` of its launch; `check` turns a
non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "flash_vstream_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# q, k, v, o, dout, lse, delta, dq, dk, dv, q_seg, kv_seg, scratch, the 24
# strides (a pointer to long long), B, Hq, Sq, Skv, Hkv, D, causal, rows per
# block, shared bytes, scale, stream
_BWD = [_P] * 13 + [ctypes.POINTER(_LL)] + [_I] * 9 + [_F, _P]
_SIGNATURES = {
    # q, k, v, o, lse, q_seg, kv_seg, 12 strides, B, Hq, Sq, Skv, Hkv, D,
    # causal, rows per block, shared bytes, scale, stream
    "fvt_flash_attention_fwd": [_P] * 7 + [_LL] * 12 + [_I] * 9 + [_F, _P],
    "fvt_flash_attention_bwd_dq": _BWD,
    "fvt_flash_attention_bwd_dkv": _BWD,
    # bank, idx, out, n_idx, row_bytes, stream
    "fvt_gather_rows": [_P, _P, _P, _I, _LL, _P],
    # x, q4, scale, partial, out, out_f32, B, dh, dout, nb, the plan
    # (split, warps, rows), stream
    "fvt_int4_matmul": [_P] * 5 + [_I] * 8 + [_P],
    # bank, idx, out, n_idx, row_bytes, stream
    "fvt_bank_gather": [_P, _P, _P, _I, _LL, _P],
    # q, k, v, o, 12 strides, B, H, S, D, q tiles, threads, variant,
    # shared bytes, scale, stream
    "fvt_frame_attention": [_P] * 4 + [_LL] * 12 + [_I] * 8 + [_F, _P],
    # x, w, out, din, dout, the plan (split, warps, rows), steps of loads
    # in flight, stream
    "fvt_bf16_v6_bf16dot": [_P] * 3 + [_I] * 6 + [_P],
    # split, warps, steps of loads in flight
    "fvt_bf16_v6_clusters": [_I, _I, _I],
}
# x, q4, scale, aux, partial, out, dh, dout, nb, blk, splits,
# rows_per_split, group, stream
for _name in ("v4_int8dot", "v7_unpackonly"):
    _SIGNATURES[f"fvt_int4_{_name}"] = [_P] * 6 + [_I] * 7 + [_P]
# x, q4, scale, out, dh, dout, nb, the plan (split, warps, rows), steps of
# loads in flight, stream
for _name in ("v1_current", "v2_biasfold", "v3_floor", "v5_u8mask"):
    _SIGNATURES[f"fvt_int4_{_name}"] = [_P] * 4 + [_I] * 7 + [_P]

_LIB = None          # the loaded library, once per process


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME to the "
                           "directory holding bin/nvcc)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfvt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists: one
    nvcc process per source, run in parallel, then one link. The compilers'
    output (with `-Xptxas -v` register and spill counts) is kept beside the
    library as `<name>.log`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        procs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], False
    for obj, proc in procs:
        logs.append(proc.communicate()[0])
        failed |= proc.returncode != 0
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *(str(o) for o, _ in procs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        failed = link.returncode != 0
    for obj, _ in procs:
        obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
    os.replace(tmp, out)     # atomic: a reader never sees half a library
    return out


def library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.fvt_error_string.argtypes = [ctypes.c_int]
        lib.fvt_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = library().fvt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}): {msg}")
