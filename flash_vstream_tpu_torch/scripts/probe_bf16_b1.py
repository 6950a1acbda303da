"""Probe: P4's B = 1 bf16 kernel on the card, against patched copies of its
source.

Each variant is a copy of this package (and of chip_smoke.py) under
build/probe_bf16_b1/<variant>/ with one edit to kernels/csrc/bf16_b1.cuh
(`PATCHES`), built there by its own `_build` and run in a process of its
own, in the order given (probe_int4_k6.py's pattern):
  alternative  l2_128 (plain 16-byte loads without L1 allocation, without
               the hint that asks the L2 for 256-byte fetches); timed, with
               the error against the plain version;
  ablation     loads_only (no byte_perm or product: the loaded words are
               only XORed together), the memory floor of the kernel's load
               pattern; nosync (each rank writes its own partial: no
               cluster barrier or DSMEM write; only a plan of several
               ranks has one); the outputs are wrong and only timed;
  fault        fault_pair (lane 0 pairs rows 1 and 0 of its low columns
               in place of 0 and 1, so those k slots meet the other row's
               x): chip_smoke.py `--only int4_probe` must fail on it; its
               error over the plain version's max is shown.
`base` is the source as it is. A timing line gives P4 ms by CUDA-graph
replay at the int4 probe's shape ([1, 3584] @ bf16 [3584, 18944], two
weight copies rotated past the L2) at groups 4, 8 and 16, `torch.matmul`
on the same inputs, the error over the plain version's max, the plan and
the ptxas registers and spills of each group's instance. `--sweep` first
times every plan (1..8 ranks of 1, 2, 4 or 8 warps) at that shape at
each group, with how many clusters of it the card holds at once (`*`
where the whole grid is resident). Needs the card and nvcc, and a checkout (chip_smoke.py at
its root).

Usage: python -m flash_vstream_tpu_torch.scripts.probe_bf16_b1
           [--sweep] [--variants base,loads_only,...,base]
"""
from __future__ import annotations

import argparse
import subprocess
import sys

from .probe_int4_k6 import ROOT, make_variant

WORK = ROOT / "build" / "probe_bf16_b1"
SRC = "kernels/csrc/bf16_b1.cuh"

_PRODUCT = "      mma_x(acc[2 * j], acc[2 * j + 1], a, st.x.x, st.x.y);\n"
_TILES = """#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t w0 = word(st.w[0], j), w1 = word(st.w[1], j);
      const uint32_t w2 = word(st.w[2], j), w3 = word(st.w[3], j);
      const uint32_t a[4] = {__byte_perm(w0, w1, 0x5410),
                             __byte_perm(w0, w1, 0x7632),
                             __byte_perm(w2, w3, 0x5410),
                             __byte_perm(w2, w3, 0x7632)};
""" + _PRODUCT + "    }\n"
_XOR = """    uint32_t h = st.x.x ^ st.x.y;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      h ^= st.w[r].x ^ st.w[r].y ^ st.w[r].z ^ st.w[r].w;
    }
    acc[0] += __uint_as_float(h & 0x007FFFFFu);
"""
# every rank writes its own partial: no cluster barrier, no DSMEM
_NOSYNC = ("  if (gridDim.y == 1) {\n    if (warp == 0) store();",
           "  if (true) {\n    if (warp == 0) store();")
_LOAD = "        st.w[r] = ld_weights(p + static_cast<long long>(r) * dout);\n"
_LOAD_128 = """        const void* q = p + static_cast<long long>(r) * dout;
        asm volatile(
            "ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\\n"
            : "=r"(st.w[r].x), "=r"(st.w[r].y), "=r"(st.w[r].z),
              "=r"(st.w[r].w)
            : "l"(q));
"""
_PAIR = "      const uint32_t a[4] = {__byte_perm(w0, w1, 0x5410),\n"

PATCHES = {
    "base": [],
    "l2_128": [(_LOAD, _LOAD_128)],
    "loads_only": [(_TILES, _XOR)],
    "nosync": [_NOSYNC],
    "fault_pair": [(_PAIR, _PAIR.replace(
        "0x5410)", "(threadIdx.x & 31) == 0 ? 0x1054 : 0x5410)"))],
}

# run in the variant's directory: P4 timed at the probe's shape, one line
_TIMING = r"""
import torch, chip_smoke as cs
from flash_vstream_tpu_torch.kernels import _build
from flash_vstream_tpu_torch.kernels import int4_variants as iv
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(3)
din, dout = 3584, 18944
w = [torch.randn(din, dout, generator=g, device=dev).to(torch.bfloat16)
     for _ in range(2)]
x = torch.randn(1, din, generator=g, device=dev).to(torch.bfloat16)
want = (x.float() @ w[0].float())
err = ((iv.v6_bf16dot_cuda(x, w[0]).float() - want).abs().max()
       / want.abs().max()).item()
ms = {grp: cs._ms(lambda i: iv.v6_bf16dot_cuda(x, w[i % 2], group=grp), 20)
      for grp in iv.GROUPS}
lib = cs._ms(lambda i: torch.matmul(x, w[i % 2]), 20)
regs = cs._ptxas_counts(_build.library_path().with_suffix(".log"),
                        cs._int4_instance)
plans = {grp: tuple(iv._p4_plan(din, dout, 0, iv.load_depth(grp)))
         for grp in iv.GROUPS}
print("ms " + " ".join(f"G{grp}={t:.4f}" for grp, t in ms.items())
      + f" torch.matmul={lib:.4f}; err/max {err:.2e}; plans " + " ".join(
          f"G{grp}={p}" for grp, p in plans.items()) + "; registers "
      + " ".join(f"G{grp}={regs[f'v6 G{grp}'][0]} spills="
                 f"{regs[f'v6 G{grp}'][1]}/{regs[f'v6 G{grp}'][2]}"
                 for grp in iv.GROUPS), flush=True)
"""

# run in the base variant's directory with --sweep: every plan at the
# probe's shape, one line
_SWEEP = r"""
import torch, chip_smoke as cs
from flash_vstream_tpu_torch.kernels import int4_matmul as im
from flash_vstream_tpu_torch.kernels import int4_variants as iv
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(3)
din, dout = 3584, 18944
tiles = dout // iv.P4_WARP_COLS
w = [torch.randn(din, dout, generator=g, device=dev).to(torch.bfloat16)
     for _ in range(2)]
x = torch.randn(1, din, generator=g, device=dev).to(torch.bfloat16)
want = iv.v6_bf16dot_cuda(x, w[0]).float()
for grp in iv.GROUPS:
    depth = iv.load_depth(grp)
    chosen = iv._p4_plan(din, dout, 0, depth)
    res = []
    for warps in iv.P4_WARPS:
        for p in im._b1_plans(din, tiles, warps):
            got = iv.v6_bf16dot_cuda(x, w[0], group=grp, plan=p).float()
            err = ((got - want).abs().max() / want.abs().max()).item()
            ms = cs._ms(lambda i: iv.v6_bf16dot_cuda(x, w[i % 2], group=grp,
                                                     plan=p), 20)
            res.append((ms, p, err, iv._card_clusters(p.split, p.warps,
                                                      depth)))
    best = min(res, key=lambda r: r[0])
    print(f"sweep v6 G{grp} [{din}, {dout}] ({tiles} tiles): chosen "
          f"{tuple(chosen)} best {tuple(best[1])} {best[0]:.4f} ms; "
          + " ".join(f"{p.split}x{p.warps}={ms:.4f}/{n}"
                     + ("*" if n >= tiles else "")
                     + ("!" if e > 1e-2 else "") for ms, p, e, n in res),
          flush=True)
"""

# run in a fault's directory: P4's error over the plain version's max at
# the probe's shape at each group, one line
_ERRORS = r"""
import torch
from flash_vstream_tpu_torch.kernels import int4_variants as iv
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(3)
w = torch.randn(3584, 18944, generator=g, device=dev).to(torch.bfloat16)
x = torch.randn(1, 3584, generator=g, device=dev).to(torch.bfloat16)
want = x.float() @ w.float()
err = {grp: ((iv.v6_bf16dot_cuda(x, w, group=grp).float() - want).abs()
             .max() / want.abs().max()).item() for grp in iv.GROUPS}
print("err/max " + " ".join(f"G{grp}={e:.2e}" for grp, e in err.items()),
      flush=True)
"""


def _last_line(res) -> str:
    lines = res.stdout.strip().splitlines()
    return (lines[-1] if res.returncode == 0 and lines
            else f"failed (rc {res.returncode}): {res.stderr[-2000:]}")


def run_variant(name: str) -> bool:
    """Build and run one variant; print its lines. False when a fault was
    not caught by `chip_smoke.py --only int4_probe` or a run failed."""
    d = make_variant(name, WORK, SRC, PATCHES)
    if name.startswith("fault_"):
        res = subprocess.run([sys.executable, "chip_smoke.py", "--only",
                              "int4_probe"], cwd=d, capture_output=True,
                             text=True)
        err = [ln for ln in (res.stdout + res.stderr).splitlines()
               if ln.startswith("AssertionError")]
        caught = res.returncode != 0 and bool(err)
        print(f"probe_bf16_b1 {name} int4_probe: "
              + (err[-1] if err else f"not caught (rc {res.returncode})"),
              flush=True)
        res = subprocess.run([sys.executable, "-c", _ERRORS], cwd=d,
                             capture_output=True, text=True)
        print(f"probe_bf16_b1 {name}: {_last_line(res)}", flush=True)
        return caught and res.returncode == 0
    res = subprocess.run([sys.executable, "-c", _TIMING], cwd=d,
                         capture_output=True, text=True)
    print(f"probe_bf16_b1 {name}: {_last_line(res)}", flush=True)
    return res.returncode == 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants", default=",".join(
        ["base", *(v for v in PATCHES if v != "base"), "base"]))
    parser.add_argument("--sweep", action="store_true",
                        help="first time every plan at the probe's shape")
    opts = parser.parse_args(argv)
    ok = True
    if opts.sweep:
        res = subprocess.run([sys.executable, "-c", _SWEEP],
                             cwd=make_variant("base", WORK, SRC, PATCHES),
                             capture_output=True, text=True)
        print(res.stdout.strip() if res.returncode == 0 else
              _last_line(res), flush=True)
        ok &= res.returncode == 0
    for v in opts.variants.split(","):
        ok &= run_variant(v)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
