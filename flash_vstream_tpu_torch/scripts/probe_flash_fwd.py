"""Probe: K1/K3's tile step on the card, against patched copies of its source.

Each variant is a copy of this package (and of chip_smoke.py) under
build/probe_flash_fwd/<variant>/ with one edit to
kernels/csrc/flash_attention.cu (`PATCHES`), built there by its own `_build`
and run in a process of its own, in the order given:
  ablations     no_load (K/V copied for the first two tiles only), no_qk,
                no_pv, no_exp: one piece of the tile step taken out, to see
                which part bounds the kernel; the outputs are wrong and only
                timed;
  alternatives  pipe (tile j + 1's scores issued before tile j's softmax,
                to overlap the two), split_kv (K and V in separate commit
                groups over 2 slots, a second barrier before P V: the
                scores wait only for K), two_slots (a 2-slot ring, one
                barrier), one_block (no 128-register cap at D 64 and 80),
                old_copy (the tile copy by a division and a 64-bit
                multiply per chunk), no_rescale (acc and l rescaled only
                when a row's max moved): measured against the shipped form
                and dropped, timed;
  faults        fault_alpha2 (one warp's alpha applied twice at its second
                tile),
                fault_skip (one warp's diagonal tile skipped), both for the
                rows 2944-2959 of head 0 of the prefill: chip_smoke.py's K1
                checks (`--only kernels`) must fail on them by the row limit
                while the 2e-2 absolute bound would pass; the error is shown.
`base` is the source as it is. Times are K1 ms by CUDA-graph replay at the
answer prefill (q [1, 28, 3008, 128], causal, the prompt's segments), the
training shape ([1, 28, 4096, 128]) causal and not, and the ViT's 448 px
frames ([4, 16, 1024, 80]), with the variant's ptxas registers at each head
dim. Needs the card and nvcc, and a checkout (chip_smoke.py at its root).

Usage: python -m flash_vstream_tpu_torch.scripts.probe_flash_fwd
           [--variants base,no_load,...,base]
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

from ..kernels.flash_attention import ROW_TOL

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
WORK = ROOT / "build" / "probe_flash_fwd"
SRC = "kernels/csrc/flash_attention.cu"

_RESCALE = """#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }
"""
_PV = "    tile_pv<D>(acc, pa, sV + t.slot * kTile, aoff);\n"
_K_COPY = "copy(sK + slot * kTile, kb + kv0 * p.k_ss, p.k_ss, p.skv - kv0);"
_V_COPY = "copy(sV + slot * kTile, vb + kv0 * p.v_ss, p.v_ss, p.skv - kv0);"
_LOOP = """  for (int j = 0; j < n_tiles; ++j) {
    if (j > 0) {
      cp_async_wait<kStages - 2>();  // tile j has landed ...
      __syncthreads();  // ... for every thread; j - 1 is done with
    }
    issue(j + kStages - 1);  // into tile j - 1's slot
    const TileCase t = classify(j);
    if (!t.skip) {
      float s[8][4];
      uint32_t pa[4][4];
      scores(t, s);
      softmax(s, pa);
      pv(t, pa);
    }
  }
"""
# tile j + 1's scores issued before tile j's softmax, two score arrays
# swapping roles in a loop unrolled by two; tile j + 2 lands meanwhile in
# the third slot
_PIPELINED = """  TileCase cur = classify(0), nxt;
  float sa[8][4], sb[8][4];
  if (!cur.skip) scores(cur, sa);
  auto step = [&](int j, const TileCase& t, const float (&s)[8][4],
                  TileCase& u, float (&s2)[8][4]) {
    if (j + 1 < n_tiles) {
      cp_async_wait<0>();
      __syncthreads();
      issue(j + kStages - 1);
      u = classify(j + 1);
      if (!u.skip) scores(u, s2);
    }
    if (!t.skip) {
      uint32_t pa[4][4];
      softmax(s, pa);
      pv(t, pa);
    }
  };
  for (int j = 0; j < n_tiles; j += 2) {
    step(j, cur, sa, nxt, sb);
    if (j + 1 < n_tiles) step(j + 1, nxt, sb, cur, sa);
  }
"""
_TWO_SLOTS = [("constexpr int kStages = 3;", "constexpr int kStages = 2;")]
_FAULT_ROWS = "w0 == 2944 && h == 0"
# variant: [(text in flash_attention.cu, its replacement), ...]; each text
# must occur exactly once
PATCHES = {
    "base": [],
    "no_load": [("    if (j < n_tiles) {\n      copy(",
                 "    if (j < min(n_tiles, 2)) {\n      copy(")],
    "no_qk": [("    tile_scores<D>(s, qf, sK + t.slot * kTile, koff);\n",
               "    for (int nt = 0; nt < 8; ++nt)\n"
               "      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] =\n"
               "          __uint_as_float(qf[0][nt & 3]);\n")],
    "no_pv": [(_PV, "    if (pa[0][0] == 0x12345678u) " + _PV.lstrip())],
    "no_exp": [(f"x[i][{e}] = ex2(fmaf(y[{e}], c, -ms{e // 2}));",
                f"x[i][{e}] = fmaf(y[{e}], c, -ms{e // 2});")
               for e in range(4)],
    "pipe": [(_LOOP, _PIPELINED)],
    "split_kv": _TWO_SLOTS + [
        ("      " + _V_COPY + "\n", ""),
        ("    }\n    cp_async_commit();\n  };",
         "    }\n    cp_async_commit();\n    if (j < n_tiles) " + _V_COPY
         + "\n    cp_async_commit();\n  };"),
        ("cp_async_wait<kStages - 2>();  // tile 0",
         "cp_async_wait<1>();  // K of tile 0"),
        ("cp_async_wait<kStages - 2>();  // tile j",
         "cp_async_wait<1>();  // K of tile j"),
        ("""    if (!t.skip) {
      float s[8][4];
      uint32_t pa[4][4];
      scores(t, s);
      softmax(s, pa);
      pv(t, pa);
    }""", """    uint32_t pa[4][4];
    if (!t.skip) {
      float s[8][4];
      scores(t, s);
      softmax(s, pa);
    }
    cp_async_wait<2>();
    __syncthreads();
    if (!t.skip) pv(t, pa);""")],
    "two_slots": _TWO_SLOTS,
    "one_block": [("__launch_bounds__(2 * kMaxRows, D > 80 ? 1 : 2)",
                   "__launch_bounds__(2 * kMaxRows, 1)")],
    "old_copy": [(_K_COPY, "copy_rows<D>(sK + slot * kTile, kb, p.k_ss, kv0, "
                  "kBlockN, p.skv);"),
                 (_V_COPY, "copy_rows<D>(sV + slot * kTile, vb, p.v_ss, kv0, "
                  "kBlockN, p.skv);")],
    "no_rescale": [(_RESCALE, "    if (!__all_sync(0xffffffffu, alpha0 == 1.f"
                    " && alpha1 == 1.f)) {\n" + _RESCALE + "    }\n")],
    "fault_alpha2": [
        ("  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;\n",
         "  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;\n"
         "  int tiles_done = 0;\n"),
        (_RESCALE, _RESCALE + f"    if (tiles_done++ == 1 && {_FAULT_ROWS})"
         " {\n" + _RESCALE + "    }\n")],
    "fault_skip": [("p.skv, w0, w1, w0 < p.sq,",
                    f"p.skv, w0, w1, w0 < p.sq && !(j == 46 && {_FAULT_ROWS}),"
                    )],
}
# the wrapper's copy of the ring's slot count (its shared-byte formula)
_PY_SLOTS = ("STAGES = 3 ", "STAGES = 2 ")

# run in the variant's directory: K1 timed at the four shapes, one line
_TIMING = r"""
import torch, chip_smoke as cs
from flash_vstream_tpu_torch.kernels import _build, flash_attention as fa
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
r = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
seg = fa.segment_ids([(2704, 2944, -1), (2984, 3008, -1)], 1, 3008, dev)
train = (r(1, 28, 4096, 128), r(1, 4, 4096, 128), r(1, 4, 4096, 128))
cases = {
    "prefill": ((r(1, 28, 3008, 128), r(1, 4, 3008, 128), r(1, 4, 3008, 128)),
                dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)),
    "train_causal": (train, dict(causal=True)),
    "train": (train, {}),
    "vit_448": ((r(4, 16, 1024, 80), r(4, 16, 1024, 80), r(4, 16, 1024, 80)),
                {}),
}
out = []
for name, (args, kw) in cases.items():
    ms = cs._ms(lambda i: fa.flash_attention_cuda(*args, **kw), 20)
    out.append(f"{name}={ms:.4f}")
regs = cs._ptxas_counts(_build.library_path().with_suffix(".log"),
                        cs._k1_instance)
print("ms " + " ".join(out) + "; registers " + " ".join(
    f"{k}={v[0]}" for k, v in sorted(regs.items())), flush=True)
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
    if "constexpr int kStages = 2;" in text:
        py = d / PKG.name / "kernels" / "flash_attention.py"
        py.write_text(py.read_text().replace(*_PY_SLOTS))
    return d


def caught_by_row(message: str) -> bool:
    """Whether chip_smoke's K1 error `message` reads an absolute error the
    2e-2 bound passes and a row error past ROW_TOL: the fault is caught by
    the row limit alone."""
    m = re.search(r"max_abs_err (\S+) .*row err (\S+)", message)
    return bool(m) and (float(m.group(1)) <= 2e-2
                        and float(m.group(2)) > ROW_TOL)


def run_variant(name: str) -> bool:
    """Build and run one variant; print its line. False when a fault was
    not caught or a timing run failed."""
    d = make_variant(name)
    if name.startswith("fault_"):
        res = subprocess.run([sys.executable, "chip_smoke.py", "--only",
                              "kernels"], cwd=d, capture_output=True,
                             text=True)
        err = [ln for ln in (res.stdout + res.stderr).splitlines()
               if ln.startswith("AssertionError")]
        print(f"probe_flash_fwd {name}: "
              + (err[-1] if err else f"not caught (rc {res.returncode})"),
              flush=True)
        return res.returncode != 0 and bool(err) and caught_by_row(err[-1])
    res = subprocess.run([sys.executable, "-c", _TIMING], cwd=d,
                         capture_output=True, text=True)
    lines = res.stdout.strip().splitlines()
    print(f"probe_flash_fwd {name}: "
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
