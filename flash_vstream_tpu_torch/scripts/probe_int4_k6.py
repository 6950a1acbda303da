"""Probe: K6's B = 1 kernel on the card, against patched copies of its source.

Each variant is a copy of this package (and of chip_smoke.py) under
build/probe_int4_k6/<variant>/ with one edit to kernels/csrc/int4_b1.cuh
(`PATCHES`), the B = 1 kernel template that K6 and the int4 probe's P3 v5,
v2, v1, v3 and v7 share (so each edit moves all six), built there by its own
`_build` and run in a process of its own, in the order given:
  alternative  sub128 (the 128 of the bf16 magic taken off per pair by a
               bf16x2 subtract, the fold then p - 8 sum x, against the
               shipped p - 136 sum x; v1 then subtracts 8, v3 and v7
               fold 0),
               depth2 and depth3 (each warp's next
               1 or 2 steps loaded before the step is summed, not after),
               depth4 (3 ahead, with the cap of 128 registers lifted: 8
               warps an SM, not 16), l2_128 (plain 16-byte loads, without
               the hint that asks the L2 for 256-byte fetches), barriers
               (rank 0 reads the ranks' sums between full cluster
               barriers, not one barrier after their writes), pe_prmt
               (P3 v2's pair of f32 nibbles packed into bf16x2 by one
               byte_perm of their high halves, exact for 0..15, not by
               F2FP); timed, with the error against the plain version;
  ablation     loads_only (no conversion or product: the loaded words are
               only XORed together), the memory floor of the kernel's load
               pattern; nosync (each rank writes its own partial: no
               cluster barrier or DSMEM read), nowait (the fold does not
               wait for its scales), loads_only_nosync; the outputs are
               wrong and only timed;
  faults       fault_fold (warp 1's fold drops the -8 sum x part of its
               bias correction for scale block 1: v5, v2, K6), fault_pair
               (lane 0's k slots paired with x of the next packed row:
               every conversion that reads x), fault_unbias (lane 0's
               subtract takes 135, not 136: v1 alone), fault_round (v7's
               epilogue without its inner bf16 round: v7 alone), in the
               shared code: chip_smoke.py
               `--only int4_probe` (P3) must fail for each, and `--only
               int4_kernel` (K6) for the two that reach K6's conversion
               (`FAULT_PHASES`); their errors are shown, then each fold
               variant's error over its plain version's max at the probe's
               shape, and which of them the fault pushes past its limit
               (K6_TOL; v7's is 0, exact).
`base` is the source as it is. Times are K6 ms by CUDA-graph replay at the
five 7B decode shapes (B = 1, weights rotated past the L2) and their sum
over one decode token's 197 calls, then P3 v5, v2, v1, v3 and v7 at the int4
probe's shape ([1, 3584] @ int4 [3584, 18944], bytes 0-255), with the
variant's ptxas registers and its errors over the plain versions' max.
Needs the card and nvcc, and a checkout (chip_smoke.py at its root).

Usage: python -m flash_vstream_tpu_torch.scripts.probe_int4_k6
           [--variants base,sub128,...,base]
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
WORK = ROOT / "build" / "probe_int4_k6"
SRC = "kernels/csrc/int4_b1.cuh"

_TILES = """#pragma unroll
      for (int j = 0; j < 16; ++j) {
        uint32_t a[4];
        Conv::tile(now, j, a);
        mma_fold(p_lo[j], p_hi[j], a, b0, b1);
      }
"""
_XOR = """      uint32_t h = b0 ^ b1;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        h ^= now.w[r].x ^ now.w[r].y ^ now.w[r].z ^ now.w[r].w;
      }
      p_lo[0] += __uint_as_float(h & 0x007FFFFFu);
"""
_B = "      const uint32_t b0 = on ? now.x.x : 0u, b1 = on ? now.x.y : 0u;\n"
_K = """      k_lo = bias * __shfl_sync(0xffffffffu, t, 0);
      k_hi = bias * __shfl_sync(0xffffffffu, t, 4);
"""
_DEPTH = "constexpr int kDepth = 1;"
# every rank writes its own partial: no cluster barrier, no DSMEM
_NOSYNC = ("  if (gridDim.y == 1) {\n    if (tid < kWarpCols) store(",
           "  if (true) {\n    if (tid < kWarpCols) store(")
# the cluster's sum as first written: full cluster barriers around rank 0
# reading every rank's sum from its shared memory
_START = ("""  if (gridDim.y > 1) {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: "memory");
  }
""", "")
_BARRIERS = ("""  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");
  if (rank > 0) {
    if (tid < kWarpCols) {
      cg::this_cluster().map_shared_rank(&gathered[0][0], 0)
          [rank * kWarpCols + tid] = v;
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: "memory");
    return;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");
  if (tid < kWarpCols) {
    for (int r = 1; r < static_cast<int>(gridDim.y); ++r) {
      v += gathered[r][tid];
    }
    store(out, out_f32, col0 + tid, epilogue(v));
  }
}
""", """\
  if (tid < kWarpCols) gathered[0][tid] = v;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every rank's sum is in its shared memory
  if (rank == 0 && tid < kWarpCols) {
    float w = 0.f;
    for (int r = 0; r < static_cast<int>(gridDim.y); ++r) {
      w += cluster.map_shared_rank(&gathered[0][0], r)[tid];
    }
    store(out, out_f32, col0 + tid, epilogue(w));
  }
  cluster.sync();   // no rank leaves while rank 0 still reads its sum
}
""")
# P3 v1's subtrahend, bf16x2 (136, 136)
_UNBIAS = ("    const __nv_bfloat162 k = __floats2bfloat162_rn(136.f, "
           "136.f);\n")
# P3 v2's pair of f32 nibbles rounded into bf16x2 (F2FP)
_PAIR = """\
    const __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(n0),
                                                   static_cast<float>(n1));
    return *reinterpret_cast<const uint32_t*>(&v);
"""
# the fold does not wait for the scales' copies
_NOWAIT = ('      asm volatile("cp.async.wait_all;\\n" ::: "memory");\n', "")
_CAP = ("__launch_bounds__(kMaxWarps * 32, 2)\n    int4_fold_kernel",
        "__launch_bounds__(kMaxWarps * 32)\n    int4_fold_kernel")

PATCHES = {
    "base": [],
    "sub128": [("    return (v & 0x000F000Fu) | 0x43004300u;\n",
                "    uint32_t r = (v & 0x000F000Fu) | 0x43004300u;\n"
                "    asm(\"sub.rn.bf16x2 %0, %0, %1;\" : \"+r\"(r) : "
                "\"r\"(0x43004300u));\n    return r;\n"),
               ("static constexpr float kBias = 136.f;",
                "static constexpr float kBias = 8.f;"),
               (_UNBIAS, _UNBIAS.replace("136.f, 136.f", "8.f, 8.f")),
               ("static constexpr float kBias = 128.f;",
                "static constexpr float kBias = 0.f;")],
    "depth2": [(_DEPTH, "constexpr int kDepth = 2;")],
    "depth3": [(_DEPTH, "constexpr int kDepth = 3;")],
    "depth4": [(_DEPTH, "constexpr int kDepth = 4;"), _CAP],
    "l2_128": [(".L2::256B.v4.u32", ".v4.u32")],
    "loads_only": [(_TILES, _XOR)],
    "barriers": [_START, _BARRIERS],
    "nosync": [_NOSYNC],
    "nowait": [_NOWAIT],
    "pe_prmt": [(_PAIR, """\
    return __byte_perm(__float_as_uint(static_cast<float>(n0)),
                       __float_as_uint(static_cast<float>(n1)), 0x7632);
""")],
    "loads_only_nosync": [(_TILES, _XOR), _NOSYNC],
    "fault_fold": [(_K, _K.replace("bias *", "(bias - (warp == 1 && cur == 1"
                                   " ? 8.f : 0.f)) *"))],
    "fault_pair": [(_B, _B.replace("const uint32_t", "uint32_t") + """\
      const uint32_t next_b0 = __shfl_sync(0xffffffffu, b0, 1);
      if (lane == 0) {
        b0 = __funnelshift_r(b0, b1, 16);
        b1 = __funnelshift_r(b1, next_b0, 16);
      }
""")],
    "fault_unbias": [(_UNBIAS, _UNBIAS.replace(
        "136.f, 136.f", "(threadIdx.x & 31) == 0 ? 135.f : 136.f, 136.f"))],
    "fault_round": [("    return __bfloat162float(__float2bfloat16(v)) * "
                     "__bfloat162float(x[0]);\n",
                     "    return v * __bfloat162float(x[0]);\n")],
}
# the chip_smoke.py phases each planted fault must fail: fault_unbias and
# fault_round are in v1's and v7's conversions alone, which K6 does not run
FAULT_PHASES = {"fault_fold": ("int4_kernel", "int4_probe"),
                "fault_pair": ("int4_kernel", "int4_probe"),
                "fault_unbias": ("int4_probe",),
                "fault_round": ("int4_probe",)}
# the int4 probe's variants on the template (chip_smoke.py P3_FOLD)
FOLD_VARIANTS = ("v1-current", "v2-biasfold", "v3-floor", "v5-u8mask",
                 "v7-unpackonly")

# run in the variant's directory: K6 timed at the five 7B shapes, one line
_TIMING = r"""
import torch, chip_smoke as cs
from flash_vstream_tpu_torch.kernels import _build
from flash_vstream_tpu_torch.kernels.int4_matmul import (
    int4_matmul_cuda, int4_matmul_reference)
from flash_vstream_tpu_torch.weights.quantize import (QuantWeight4,
                                                      quantize_weight4)
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(3)
out, total, err = [], 0.0, None
for name, din, dout, calls in cs.K6_SHAPES:
    qw = quantize_weight4(torch.randn(din, dout, generator=g, device=dev)
                          * din ** -0.5)
    n = min(63, -(-100_000_000 // cs._nbytes(*qw)))
    copies = [qw] + [QuantWeight4(qw.q4.clone(), qw.scale.clone())
                     for _ in range(n - 1)]
    x = torch.randn(1, din, generator=g, device=dev).to(torch.bfloat16)
    if err is None:
        want = int4_matmul_reference(x, *qw, torch.float32)
        err = ((int4_matmul_cuda(x, *qw).float() - want).abs().max()
               / want.abs().max()).item()
    ms = cs._ms(lambda i: int4_matmul_cuda(x, *copies[i % n]),
                max(20, 2 * n))
    total += calls * ms
    out.append(f"{name}={ms:.4f}")
    del copies, qw
    torch.cuda.empty_cache()
from flash_vstream_tpu_torch.kernels import int4_variants as iv
q = [torch.randint(0, 256, (1792, 18944), generator=g, device=dev,
                   dtype=torch.uint8) for _ in range(3)]
s = [torch.rand(28, 18944, generator=g, device=dev) * 2e-3 + 5e-4
     for _ in range(3)]
x = torch.randn(1, 3584, generator=g, device=dev).to(torch.bfloat16)
for kern in (iv.v5_u8mask_cuda, iv.v2_biasfold_cuda, iv.v1_current_cuda,
             iv.v3_floor_cuda, iv.v7_unpackonly_cuda):
    ref = getattr(iv, kern.__name__[:-5] + "_reference")
    # v7 against its bf16 output (exact); the others against f32 sums
    want = (ref(x, q[0], s[0]).float() if kern is iv.v7_unpackonly_cuda
            else ref(x, q[0], s[0], out_dtype=torch.float32))
    e = ((kern(x, q[0], s[0]).float() - want).abs().max()
         / want.abs().max()).item()
    ms = cs._ms(lambda i: kern(x, q[i % 3], s[i % 3]), 20)
    out.append(f"{kern.__name__[:-5]}={ms:.4f} (err/max {e:.2e})")
log = _build.library_path().with_suffix(".log")
regs = cs._ptxas_counts(log, cs._k6_instance)
regs.update((k, v) for k, v in cs._ptxas_counts(log, cs._int4_instance).items()
            if k in ("v5 G4", "v2 G4", "v1 G4", "v3 G4", "v7 G4"))
print("ms " + " ".join(out[:5]) + f" per_token={total:.4f}; err/max at "
      f"gate/up {err:.3e}; P3 " + " ".join(out[5:]) + "; registers "
      + " ".join(f"{k}={v[0]} spills={v[1]}/{v[2]}"
                 for k, v in sorted(regs.items())), flush=True)
"""


# run in a fault's directory: each fold variant's error over its plain
# version's max at the int4 probe's shape (group 4), and those past their
# limit (chip_smoke's P3_TOL, else K6_TOL; exact variants against their
# bf16 output), one line
_ERRORS = r"""
import torch, chip_smoke as cs
from flash_vstream_tpu_torch.kernels import int4_variants as iv
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(3)
q = torch.randint(0, 256, (1792, 18944), generator=g, device=dev,
                  dtype=torch.uint8)
s = torch.rand(28, 18944, generator=g, device=dev) * 2e-3 + 5e-4
x = torch.randn(1, 3584, generator=g, device=dev).to(torch.bfloat16)
res, past = [], []
for name in cs.P3_FOLD:
    stem = name.replace("-", "_")
    ref = getattr(iv, stem + "_reference")
    tol = cs.P3_TOL.get(name, cs.K6_TOL)
    want = (ref(x, q, s).float() if name in cs.P3_TOL
            else ref(x, q, s, out_dtype=torch.float32))
    got = getattr(iv, stem + "_cuda")(x, q, s).float()
    e = ((got - want).abs().max() / want.abs().max()).item()
    res.append(f"{name}={e:.2e}")
    if not e <= tol:
        past.append(name)
print("err/max " + " ".join(res) + "; past the limit: " + " ".join(past),
      flush=True)
"""


# run in the base variant's directory with --sweep: every B = 1 plan of 4
# and of 8 warps at each 7B shape, one line a shape
_SWEEP = r"""
import torch, chip_smoke as cs
from flash_vstream_tpu_torch.kernels import int4_matmul as im
from flash_vstream_tpu_torch.weights.quantize import (QuantWeight4,
                                                      quantize_weight4)
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(3)
for name, din, dout, calls in cs.K6_SHAPES:
    qw = quantize_weight4(torch.randn(din, dout, generator=g, device=dev)
                          * din ** -0.5)
    n = min(63, -(-100_000_000 // cs._nbytes(*qw)))
    copies = [qw] + [QuantWeight4(qw.q4.clone(), qw.scale.clone())
                     for _ in range(n - 1)]
    x = torch.randn(1, din, generator=g, device=dev).to(torch.bfloat16)
    want = im.int4_matmul_cuda(x, *qw, torch.float32)
    chosen = im._plan(1, din // 2, qw.scale.shape[0], dout, im._sms(0))
    res = []
    for warps in (4, 8):
        for p in im._b1_plans(din // 2, dout // im.WARP_COLS):
            p = p._replace(warps=warps)
            got = im.int4_matmul_cuda(x, *qw, torch.float32, plan=p)
            err = ((got - want).abs().max() / want.abs().max()).item()
            ms = cs._ms(lambda i: im.int4_matmul_cuda(x, *copies[i % n],
                                                      plan=p), max(20, 2 * n))
            res.append((ms, p, err))
    best = min(res, key=lambda r: r[0])
    print(f"sweep {name}: chosen {tuple(chosen)} best {tuple(best[1])} "
          f"{best[0]:.4f} ms; " + " ".join(
              f"{p.split}x{p.warps}={ms:.4f}" + ("!" if e > 1e-4 else "")
              for ms, p, e in res), flush=True)
    del copies, qw
    torch.cuda.empty_cache()
"""


def make_variant(name: str, work: Path = WORK, src: str = SRC,
                 patches: dict = PATCHES) -> Path:
    """A copy of the package and chip_smoke.py with the variant's edits
    (`patches[name]`, to `src`), at work / name."""
    if name not in patches:
        raise SystemExit(f"unknown variant {name}; known: {sorted(patches)}")
    d = work / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(PKG, d / PKG.name, ignore=shutil.ignore_patterns(
        "__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", d)
    cu = d / PKG.name / src
    text = cu.read_text()
    for old, new in patches[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the text to patch occurs "
                             f"{text.count(old)} times: {old!r}")
        text = text.replace(old, new)
    cu.write_text(text)
    return d


def run_variant(name: str) -> tuple:
    """Build and run one variant; print its lines. Returns (ok, the fold
    variants a fault pushed past their limit, as names); ok is False when a
    fault was not caught by a phase of `FAULT_PHASES` or a run failed."""
    d = make_variant(name)
    if name.startswith("fault_"):
        caught = []
        for phase in FAULT_PHASES[name]:
            res = subprocess.run([sys.executable, "chip_smoke.py", "--only",
                                  phase], cwd=d, capture_output=True,
                                 text=True)
            err = [ln for ln in (res.stdout + res.stderr).splitlines()
                   if ln.startswith("AssertionError")]
            print(f"probe_int4_k6 {name} {phase}: "
                  + (err[-1] if err else f"not caught (rc {res.returncode})"),
                  flush=True)
            caught.append(res.returncode != 0 and bool(err))
        res = subprocess.run([sys.executable, "-c", _ERRORS], cwd=d,
                             capture_output=True, text=True)
        line = (res.stdout.strip().splitlines() or [""])[-1]
        ran = res.returncode == 0 and "past the limit:" in line
        print(f"probe_int4_k6 {name}: " + (
            line if ran
            else f"failed (rc {res.returncode}): {res.stderr[-2000:]}"),
            flush=True)
        past = set(line.split("past the limit:")[1].split()) if ran else set()
        return all(caught) and ran, past
    res = subprocess.run([sys.executable, "-c", _TIMING], cwd=d,
                         capture_output=True, text=True)
    lines = res.stdout.strip().splitlines()
    print(f"probe_int4_k6 {name}: "
          + (lines[-1] if res.returncode == 0 and lines
             else f"failed (rc {res.returncode}): {res.stderr[-2000:]}"),
          flush=True)
    return res.returncode == 0, set()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants", default=",".join(
        ["base", *(v for v in PATCHES if v != "base"), "base"]))
    parser.add_argument("--sweep", action="store_true",
                        help="first time every B = 1 plan (cluster size, 4 "
                             "and 8 warps) at each 7B shape")
    opts = parser.parse_args(argv)
    if opts.sweep:
        res = subprocess.run([sys.executable, "-c", _SWEEP],
                             cwd=make_variant("base"), capture_output=True,
                             text=True)
        print(res.stdout.strip() or f"sweep failed: {res.stderr[-2000:]}",
              flush=True)
    runs = [(v, run_variant(v)) for v in opts.variants.split(",")]
    ok = all(r[0] for _, r in runs)
    past = {v: r[1] for v, r in runs if v in FAULT_PHASES}
    if set(FAULT_PHASES) <= set(past):
        # between them the faults must push every fold variant past its
        # limit
        by = {v: [f for f in FAULT_PHASES if v in past[f]]
              for v in FOLD_VARIANTS}
        print("probe_int4_k6 faults: " + " ".join(
            f"{v} by {','.join(fs) or 'none'}" for v, fs in by.items()),
            flush=True)
        ok &= all(by.values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
