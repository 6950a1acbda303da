"""Probe: the DAM frame gather (spa_x = bank[idx]) by four routes on the card.

Port of scripts/probe_bank_gather.py. Routes (`MODES`):
  xla     bank.index_select(0, idx), PyTorch's own gather (the JAX probe's
          `bank[idx]`)
  onehot  one_hot(idx) @ bank.reshape(T, -1): reads the WHOLE bank, on the
          tensor cores (a plain torch.matmul)
  k2      the CUDA kernel K2 (kernels/gather_rows.py): a vector copy through
          the threads' registers
  bulk    the CUDA kernel P1 (kernels/bank_gather.py), the port of the JAX
          probe's `pallas` route: each row streams through shared memory by
          bulk (TMA) copies, the TPU's one DMA per row
Each route runs as a chained loop of --iters gathers with fresh indices per
iteration ((arange(K) * 7 + i) % T) and state carried across iterations,
timed by CUDA-graph replay, best of 4 (scripts/timing.py). On the CPU
(--device cpu, at small sizes) k2 and bulk take their kernels' plain
versions.

On the card, three readings of P1 alone, each a line:
  --fixed   its fixed cost: K 1, one 1,008-byte row (bank [50, 7, 72]
            bf16), P1, K2 and index_select by graph replay; then P1 at the
            probe's shape (`p1_ms`: 32 index sets rotating past the L2);
  --sweep   P1 at the probe's shape in patched copies of
            csrc/bank_gather.cu (`SWEEP`) under build/probe_bank_gather/,
            each built by its own `_build` (BUILDS at a time) and run in
            a process of its own, the source as it is first and last:
            every ring of stage 8, 16 or 32 KB and 2, 3, 4 or 6 stages,
            and the shipped ring without the stores' L2 evict_first
            policy; per copy the resident blocks the driver reports, the
            plan's grid and shares and ms by graph replay (32 index sets
            rotating past the L2), each bit-exact against index_select;
  --faults  planted faults in patched copies of csrc/bank_gather.cu
            (`FAULTS`; a share cut 16 bytes short), each of which
            `chip_smoke.py --only bank_gather` must fail; the error it read
            is printed.

Usage: python -m flash_vstream_tpu_torch.scripts.probe_bank_gather
           [--t 1024] [--k 30] [--p 256] [--d 1280] [--iters 50]
           [--dtype bfloat16] [--device cuda] [--fixed] [--sweep] [--faults]
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..kernels.bank_gather import (bank_gather, bank_gather_cuda,
                                   bank_gather_reference)
from ..kernels.gather_rows import gather_rows, gather_rows_cuda
from .timing import graph_seconds

TRIALS = 4
WORK = Path(__file__).resolve().parents[2] / "build" / "probe_bank_gather"
SRC = "kernels/csrc/bank_gather.cu"
BUILDS = 4                # sweep copies built at once
_STAGES = "constexpr int kStages = 4;\n"
_STAGE_BYTES = "constexpr int kStageBytes = 16 * 1024;\n"
_EVICT = "constexpr bool kEvictFirst = true;\n"
# the sweep's copies, (old, new) edits of csrc/bank_gather.cu: "base" the
# source as it is (16 KB x 4, evict_first stores), ring_<KB>k_x<stages>
# another ring, no_evict_first the stores without the L2 policy
SWEEP = {"base": []}
SWEEP.update({
    f"ring_{kb}k_x{n}": [
        (_STAGE_BYTES, f"constexpr int kStageBytes = {kb} * 1024;\n"),
        (_STAGES, f"constexpr int kStages = {n};\n")]
    for kb in (8, 16, 32) for n in (2, 3, 4, 6) if (kb, n) != (16, 4)})
SWEEP["no_evict_first"] = [(_EVICT, "constexpr bool kEvictFirst = false;\n")]
# planted faults, (old, new) edits of csrc/bank_gather.cu
FAULTS = {
    "fault_share": [(
        "  const long long len = share + (c < extra ? unit : 0);\n",
        "  const long long len = share + (c < extra ? unit : 0) - 16;\n")],
}
# run in a sweep copy's directory with t, k, p, d: its line
_SWEEP_POINT = r"""
import sys, torch
from flash_vstream_tpu_torch.kernels.bank_gather import card_plan, card_ring
from flash_vstream_tpu_torch.scripts import probe_bank_gather as probe
t, k, p, d = map(int, sys.argv[1:5])
dev = torch.device("cuda", 0)
bank = probe.make_bank(t, p, d, torch.bfloat16, dev)
ms = probe.p1_ms(bank, k)
resident, stage_bytes, stages = card_ring(0)
plan = card_plan(k, p * d * 2, 0)
print(f"stage {stage_bytes // 1024} KB x {stages}: resident {resident}, "
      f"grid {plan.splits} x {plan.rows}, shares of ~{plan.share} B, "
      f"bit-exact, {ms:.4f} ms")
"""


def gather_xla(bank: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return bank.index_select(0, idx)


def gather_onehot(bank: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """one_hot(idx) [K, T] @ bank [T, P*D], one rounding of the f32 sums to
    the bank's dtype (exact: one term per output)."""
    T, P, D = bank.shape
    oh = F.one_hot(idx.long(), T).to(bank.dtype)
    return torch.matmul(oh, bank.reshape(T, P * D)).reshape(-1, P, D)


MODES: Dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = {
    "xla": gather_xla,
    "onehot": gather_onehot,
    "k2": gather_rows,
    "bulk": bank_gather,
}


def chained_loop(fn, bank: torch.Tensor, k: int, iters: int):
    """The probe's chain: `iters` gathers of k rows with fresh indices, each
    output's first element summed into the carried state."""
    T = bank.shape[0]

    def loop() -> torch.Tensor:
        acc = torch.zeros((), dtype=torch.float32, device=bank.device)
        for i in range(iters):
            idx = (torch.arange(k, dtype=torch.int32, device=bank.device) * 7
                   + i) % T
            acc = acc + fn(bank, idx).reshape(-1)[0].float()
        return acc
    return loop


def make_bank(t: int, p: int, d: int, dtype: torch.dtype,
              device: torch.device, seed: int = 0) -> torch.Tensor:
    """N(0, 1) bank [t, p, d] in `dtype`, drawn on `device`."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(t, p, d, generator=g, device=device).to(dtype)


def fixed_case(device: torch.device):
    """(bank, idx) of P1's fixed-cost reading: K 1, one row of 7 x 72 bf16
    (1,008 bytes)."""
    return (make_bank(50, 7, 72, torch.bfloat16, device),
            torch.tensor([17], dtype=torch.int32, device=device))


def _graph_ms(fn, device: torch.device, iters: int = 64) -> float:
    """Device ms per call of `iters` calls fn(i) (each returning a tensor)
    by graph replay, best of 3. Each output but the last is dropped at
    once, so the calls write one buffer, as chip_smoke.py's `_ms` times
    them."""
    def loop() -> torch.Tensor:
        for i in range(iters - 1):
            fn(i)
        return fn(iters - 1).reshape(-1)[0].float()
    return graph_seconds(loop, device, 3) * 1e3 / iters


def fixed_cost(bank: torch.Tensor, k: int) -> Dict[str, float]:
    """P1, K2 and index_select at K 1 (1,008 bytes), ms a call, and P1 at
    `bank` and k rows (`p1_ms`)."""
    small, idx = fixed_case(bank.device)
    lidx = idx.long()
    res = {"p1": _graph_ms(lambda i: bank_gather_cuda(small, idx),
                           bank.device),
           "k2": _graph_ms(lambda i: gather_rows_cuda(small, idx),
                           bank.device),
           "index_select": _graph_ms(lambda i: small.index_select(0, lidx),
                                     bank.device)}
    res["p1_k"] = p1_ms(bank, k)
    print("fixed K 1 (1,008 B row): " + " ".join(
        f"{n}={res[n]:.4f}" for n in ("p1", "k2", "index_select"))
        + f" ms; P1 at K {k} of bank{tuple(bank.shape)}: {res['p1_k']:.4f} "
        f"ms", flush=True)
    return res


def p1_ms(bank: torch.Tensor, k: int) -> float:
    """P1's ms a call of k rows by graph replay, over 32 index sets rotating
    past the L2, after a check that it is bit-exact against
    index_select."""
    device = bank.device
    g = torch.Generator(device=device).manual_seed(5)
    idxs = [torch.randint(0, bank.shape[0], (k,), generator=g, device=device,
                          dtype=torch.int64).to(torch.int32)
            for _ in range(32)]
    if not torch.equal(bank_gather_cuda(bank, idxs[0]),
                       bank_gather_reference(bank, idxs[0])):
        raise AssertionError("P1: not bit-exact")
    return _graph_ms(lambda i: bank_gather_cuda(bank, idxs[i % 32]), device)


def sweep(t: int, k: int, p: int, d: int) -> Dict[str, float]:
    """P1 in each copy of `SWEEP` at bank [t, p, d] bf16 and k rows, base
    first and last, one line each, then the fastest: {copy: ms} (base's the
    better of its two)."""
    from .probe_int4_k6 import make_variant
    names = list(SWEEP)
    dirs = {n: make_variant(n, WORK, SRC, SWEEP) for n in names}
    running = []
    for n in [*names, None]:
        # at most BUILDS copies build at once, each with an nvcc a source
        while running and (n is None or len(running) == BUILDS):
            name, b = running.pop(0)
            if b.wait() != 0:
                raise RuntimeError(f"sweep {name}: build failed: "
                                   f"{b.stderr.read()[-2000:]}")
        if n is not None:
            running.append((n, subprocess.Popen(
                [sys.executable, "-c", "from flash_vstream_tpu_torch.kernels "
                 "import _build; _build.build()"], cwd=dirs[n],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True)))
    res = {}
    for n in [*names, "base"]:
        run = subprocess.run([sys.executable, "-c", _SWEEP_POINT, *map(
            str, (t, k, p, d))], cwd=dirs[n], capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"sweep {n}: {run.stderr[-2000:]}")
        line = run.stdout.strip().splitlines()[-1]
        ms = float(line.split()[-2])
        res[n] = min(ms, res.get(n, ms))
        print(f"sweep {n}: {line}", flush=True)
    best = min(res, key=res.get)
    print(f"sweep fastest: {best} {res[best]:.4f} ms; base {res['base']:.4f} "
          f"ms", flush=True)
    return res


def run_faults() -> bool:
    """Each planted fault in a patched copy of the package: `chip_smoke.py
    --only bank_gather` must fail with an AssertionError; prints what it
    read. True when every fault was caught."""
    from .probe_int4_k6 import make_variant
    caught = True
    for name in FAULTS:
        d = make_variant(name, WORK, SRC, FAULTS)
        res = subprocess.run([sys.executable, "chip_smoke.py", "--only",
                              "bank_gather"], cwd=d, capture_output=True,
                             text=True)
        err = [ln for ln in (res.stdout + res.stderr).splitlines()
               if ln.startswith("AssertionError")]
        print(f"probe_bank_gather {name} bank_gather: "
              + (err[-1] if err else f"not caught (rc {res.returncode})"),
              flush=True)
        caught &= res.returncode != 0 and bool(err)
    return caught


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--t", type=int, default=1024)
    ap.add_argument("--k", type=int, default=30)
    ap.add_argument("--p", type=int, default=256)
    ap.add_argument("--d", type=int, default=1280)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--dtype", type=str, default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--fixed", action="store_true",
                    help="also P1's fixed cost at K 1 (card only)")
    ap.add_argument("--sweep", action="store_true",
                    help="also P1 at every ring (card only)")
    ap.add_argument("--faults", action="store_true",
                    help="also the planted faults (card only)")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Runs the routes, prints one line each, then the card readings asked
    for; returns {mode: seconds per gather}. Raises if a planted fault was
    not caught."""
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda" and (args.fixed or args.sweep or args.faults):
        raise ValueError("--fixed, --sweep and --faults time or patch the "
                         "CUDA kernel: they need the card")
    T, K = args.t, args.k
    dtype = getattr(torch, args.dtype)
    bank = make_bank(T, args.p, args.d, dtype, device)
    nbytes = K * args.p * args.d * bank.element_size()
    results = {}
    for mode, fn in MODES.items():
        loop = chained_loop(fn, bank, K, args.iters)
        dt = graph_seconds(loop, device, TRIALS) / args.iters
        results[mode] = dt
        print(f"{mode:10s} {dt * 1e3:7.3f} ms   {nbytes / dt / 1e9:7.1f} GB/s "
              f"gathered ({nbytes / 1e6:.1f} MB)", flush=True)
    if args.fixed:
        fixed_cost(bank, K)
    if args.sweep:
        sweep(T, K, args.p, args.d)
    if args.faults and not run_faults():
        raise AssertionError("a planted fault in P1 was not caught")
    return results


if __name__ == "__main__":
    main()
