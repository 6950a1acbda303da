"""Probe: K4/K5's tile steps on the card, against patched copies of their
source.

Each variant is a copy of this package (and of chip_smoke.py) under
build/probe_flash_bwd/<variant>/ with one edit to
kernels/csrc/flash_attention_bwd.cu (`PATCHES`), built there by its own
`_build` and run in a process of its own, in the order given:
  ablations  no_load_dq (K4's K/V tiles copied for the first two tiles
             only), no_load_dkv (K5's Q/dO tiles likewise), no_exp_dq,
             no_exp_dkv (the exponent's argument used as p, no MUFU): one
             piece taken out, to see what bounds each kernel; the outputs
             are wrong and only timed;
  faults     fault_dq_ds (one warp's dS tile dropped in K4: rows 2944-2959
             of q head 0 miss keys 1280-1343), fault_dkv_head (K5's second
             pass leaves q head 6 of kv head 0's group out of the sum for kv
             rows 2944-2959): chip_smoke.py's backward checks (`--only
             backward`) must fail on each by the row limit while the old
             limit, 2e-2 of the tensor's max, would pass; the error is shown.
`base` is the source as it is. Times are K4 and K5 ms by CUDA-graph replay
at the training shape (q [1, 28, 4096, 128], k/v [1, 4, 4096, 128], causal,
the segments of chip_smoke's `train` case), with the variant's ptxas
registers and spills of each instance. Needs the card and nvcc, and a
checkout (chip_smoke.py at its root).

Usage: python -m flash_vstream_tpu_torch.scripts.probe_flash_bwd
           [--variants base,no_load_dq,...,base]
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

from .probe_flash_fwd import PKG, ROOT

WORK = ROOT / "build" / "probe_flash_bwd"
SRC = "kernels/csrc/flash_attention_bwd.cu"
GRAD_TOL = 2e-2     # chip_smoke's limit on dq/dk/dv, of the tensor's max and
                    # of each row's max

_FAULT_ROWS = "w0 == 2944 && h == 0"
# variant: [(text in flash_attention_bwd.cu, its replacement), ...]; each
# text must occur exactly once
PATCHES = {
    "base": [],
    "no_load_dq": [("    if (j < n_tiles) {\n      copy(sK",
                    "    if (j < min(n_tiles, 2)) {\n      copy(sK")],
    "no_load_dkv": [("    if (first + i < n_q) {\n      copy(sQ",
                     "    if (first + i < n_q && i < 2) {\n      copy(sQ")],
    "no_exp_dq": [("float pr = ex2(fmaf(s[nt][e], c, -(top ? l0 : l1)));",
                   "float pr = fmaf(s[nt][e], c, -(top ? l0 : l1));")],
    "no_exp_dkv": [("float pr = ex2(fmaf(st[nt][e], c, -l));",
                    "float pr = fmaf(st[nt][e], c, -l);")],
    "sub16_dkv": [("constexpr int kSub = D > 80 ? 32 : 64;  // q rows",
                   "constexpr int kSub = D > 80 ? 16 : 64;  // q rows")],
    "unroll_dkv": [("#pragma unroll 1\n    for (int sub = 0;",
                    "#pragma unroll\n    for (int sub = 0;")],
    "fault_dq_ds": [("    if (t.skip) continue;\n    const __nv_bfloat16* tk",
                     f"    if (t.skip || (j == 20 && {_FAULT_ROWS})) continue;"
                     "\n    const __nv_bfloat16* tk")],
    "fault_dkv_head": [("  for (int j = 1; j < p.group; ++j) {",
                        "  for (int j = 1; j < (s >= 2944 && s < 2960 && "
                        "hk == 0 ? p.group - 1 : p.group); ++j) {")],
}

# run in the variant's directory: K4 and K5 timed at the training shape, one
# line
_TIMING = r"""
import torch, chip_smoke as cs
from flash_vstream_tpu_torch.kernels import _build, flash_attention as fa
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
r = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
S = 4096
seg = fa.segment_ids([(3000, 3100, -1), (3900, S, -1)], 1, S, dev)
q, k, v, do = r(1, 28, S, 128), r(1, 4, S, 128), r(1, 4, S, 128), r(1, 28, S, 128)
kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
out, lse = fa.flash_attention_fwd_lse_cuda(q, k, v, **kw)
dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, out, do, lse, **kw)
k4 = cs._ms(lambda i: fa.flash_attention_bwd_dq_cuda(q, k, v, out, do, lse,
                                                     **kw), 10)
k5 = cs._ms(lambda i: fa.flash_attention_bwd_dkv_cuda(
    q, k, v, out, do, lse, delta, **kw), 10)
regs = cs._ptxas_counts(_build.library_path().with_suffix(".log"),
                        cs._bwd_instance)
print(f"ms K4={k4:.4f} K5={k5:.4f}; registers/spill stores " + " ".join(
    f"{n}={v[0]}/{v[1]}" for n, v in sorted(regs.items())), flush=True)
"""


def make_variant(name: str, work: Path = WORK) -> Path:
    """A copy of the package and chip_smoke.py with the variant's edits,
    at work / name."""
    if name not in PATCHES:
        raise SystemExit(f"unknown variant {name}; known: {sorted(PATCHES)}")
    d = work / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(PKG, d / PKG.name, ignore=shutil.ignore_patterns(
        "__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", d)
    cu = d / PKG.name / SRC
    text = cu.read_text()
    for old, new in PATCHES[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the text to patch occurs "
                             f"{text.count(old)} times: {old!r}")
        text = text.replace(old, new)
    cu.write_text(text)
    return d


def caught_by_row(message: str) -> bool:
    """Whether chip_smoke's backward error `message` reads every gradient
    within GRAD_TOL of its tensor's max (the old limit passes) and one row
    past GRAD_TOL of its own max: the fault is caught by the row limit
    alone."""
    m = re.search(r"grads/max dq=(\S+) dk=(\S+) dv=(\S+) by row dq=(\S+) "
                  r"dk=(\S+) dv=(\S+)", message)
    if not m:
        return False
    rel, row = ([float(x) for x in m.groups()[i:i + 3]] for i in (0, 3))
    return max(rel) <= GRAD_TOL and max(row) > GRAD_TOL


def run_variant(name: str) -> bool:
    """Build and run one variant; print its line. False when a fault was
    not caught by the row limit alone or a timing run failed."""
    d = make_variant(name)
    if name.startswith("fault_"):
        res = subprocess.run([sys.executable, "chip_smoke.py", "--only",
                              "backward"], cwd=d, capture_output=True,
                             text=True)
        err = [ln for ln in (res.stdout + res.stderr).splitlines()
               if ln.startswith("AssertionError")]
        print(f"probe_flash_bwd {name}: "
              + (err[-1] if err else f"not caught (rc {res.returncode})"),
              flush=True)
        return res.returncode != 0 and bool(err) and caught_by_row(err[-1])
    res = subprocess.run([sys.executable, "-c", _TIMING], cwd=d,
                         capture_output=True, text=True)
    lines = res.stdout.strip().splitlines()
    print(f"probe_flash_bwd {name}: "
          + (lines[-1] if res.returncode == 0 and lines
             else f"failed (rc {res.returncode}): {res.stderr[-2000:]}"),
          flush=True)
    return res.returncode == 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants", default=",".join(
        ["base", *(v for v in PATCHES if v != "base"), "base"]))
    opts = parser.parse_args(argv)
    ok = [run_variant(v) for v in opts.variants.split(",")]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
