"""P1 (bank gather by bulk copies): the port's plain version against the
Pallas gather run in interpret mode and against `jnp.take`, the DAM-gather
probe's routes against each other, the kernel's plan (one wave of rows
cut into equal byte shares, each cut into bulk copies) without a card, and
the CUDA kernel against the plain version on a card. A gather moves bits, so every
comparison is exact.

The probe's own Pallas kernel (scripts/probe_bank_gather.py:81) is defined
inside its `main()`; `flash_vstream_tpu.kernels.gather_rows._pallas_gather`
has the same body and grid spec, so the interpret-mode check runs that.

The machine with the card has no JAX, so JAX loads in a fixture; there the
card tests run alone:
    python -m pytest --noconftest -m gpu tests/test_torch_bank_gather.py
"""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from flash_vstream_tpu_torch.kernels.bank_gather import (
    ALIGN, UNIT, bank_gather, bank_gather_cuda, bank_gather_plan,
    bank_gather_reference, block_copies, card_ring)
from flash_vstream_tpu_torch.scripts import probe_bank_gather as probe

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jgr():
    """The JAX gather module (and jnp as jgr.jnp)."""
    pytest.importorskip("jax")
    from flash_vstream_tpu.kernels import gather_rows as module
    return module


def _case(jnp, dtype):
    rng = np.random.default_rng(0)
    bank = rng.normal(size=(24, 8, 128)).astype(np.float32)
    idx = np.array([5, 0, 23, 5, 11, 7], np.int32)
    jb = jnp.asarray(bank, dtype)
    tb = torch.from_numpy(bank).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return jb, tb, idx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_pallas_interpret(jgr, dtype):
    from jax.experimental.pallas import tpu as pltpu
    jnp = jgr.jnp
    jb, tb, idx = _case(jnp, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jgr._pallas_gather(jb, jnp.asarray(idx)), np.float32)
    got = bank_gather(tb, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_take(jgr, dtype):
    jnp = jgr.jnp
    jb, tb, idx = _case(jnp, dtype)
    want = np.asarray(jnp.take(jb, jnp.asarray(idx), axis=0), np.float32)
    got = bank_gather_reference(tb, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_probe_routes_agree(dtype):
    """xla, onehot, k2 and bulk give the same rows (k2 and bulk take their
    plain versions on the CPU), and the chained loop carries the first
    element of every gather."""
    bank = probe.make_bank(16, 4, 32, dtype, torch.device("cpu"))
    idx = (torch.arange(5, dtype=torch.int32) * 7 + 3) % 16
    want = probe.gather_xla(bank, idx)
    for mode, fn in probe.MODES.items():
        assert torch.equal(fn(bank, idx), want), mode
    acc = probe.chained_loop(probe.gather_onehot, bank, 5, 4)()
    firsts = [bank[(7 * 0 + i) % 16].reshape(-1)[0].float() for i in range(4)]
    assert acc.item() == pytest.approx(float(sum(firsts)), rel=1e-6)


def test_probe_main_runs_on_cpu(capsys):
    res = probe.main(["--device", "cpu", "--t", "32", "--k", "3", "--p", "4",
                      "--d", "32", "--iters", "2"])
    assert set(res) == set(probe.MODES)
    assert all(v > 0 for v in res.values())
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == list(probe.MODES)


# P1's plan at (K, row bytes, resident blocks, stage bytes): the probe's
# shape (30 rows of 256 x 1280 bf16) at 3 and 2 blocks an SM of 132 SMs
# with 16 KB stages, at 14 an SM with 8 KB stages, at one an SM with 32 KB
# stages, and with 40 KB and 8 MB stages (shares capped at a stage: 16 and
# 1 a row); K 1 with a 1,008-byte row (one stage: one block); rows of
# 2,056 x 3 x 2 bytes at K 7 and 5; K 70,000 of 32-byte rows and K 500 of
# the probe's rows (more rows than blocks: whole rows a block)
PLAN_CASES = [
    (30, 655_360, 396, 16384), (30, 655_360, 264, 16384),
    (30, 655_360, 1848, 8192), (30, 655_360, 132, 32768),
    (30, 655_360, 396, 40960), (30, 655_360, 396, 1 << 23),
    (1, 1008, 396, 16384), (7, 12_336, 396, 16384), (5, 12_336, 396, 8192),
    (70_000, 32, 396, 16384), (70_000, 32, 1848, 8192),
    (500, 655_360, 396, 16384),
]


@pytest.mark.parametrize("n_idx,row_bytes,resident,stage", PLAN_CASES)
def test_plan_is_one_wave_of_equal_shares(n_idx, row_bytes, resident, stage):
    """Every output byte is copied exactly once; no copy straddles a row;
    every copy is a multiple of 16 bytes and at most a stage; the shares of
    a row start on a unit (the largest power of two up to 128 that divides
    the row) and differ by at most one, and every row is cut alike; no more
    blocks than are resident (one wave), as many shares a row as resident
    // K allows (at least one, no more than the row has stages); where the
    rows outnumber the blocks, the blocks' row counts differ by at most
    one."""
    plan = bank_gather_plan(n_idx, row_bytes, resident, stage)
    assert plan.unit == {655_360: 128, 1008: 16, 12_336: 16, 32: 32}[row_bytes]
    assert ALIGN % plan.unit == 0 and row_bytes % plan.unit == 0
    assert plan.blocks <= resident
    assert plan.rows == min(n_idx, resident)
    assert plan.splits == max(1, min(resident // n_idx, -(-row_bytes // stage),
                                     row_bytes // plan.unit))
    covered = np.zeros((n_idx, row_bytes // UNIT), np.int32)
    shares = np.zeros((n_idx, plan.splits), np.int64)
    rows = []
    for b in range(plan.blocks):
        copies = block_copies(plan, n_idx, row_bytes, stage, b)
        rows.append(len({r for r, _, _ in copies}))
        for row, off, n in copies:
            assert 0 < n <= stage and n % UNIT == 0
            assert off % plan.unit == 0       # stages are whole units here
            assert off + n <= row_bytes       # never past the row's end
            covered[row, off // UNIT:(off + n) // UNIT] += 1
            shares[row, b % plan.splits] += n
    assert (covered == 1).all()
    assert (shares == shares[0]).all()
    assert shares[0].max() - shares[0].min() <= plan.unit
    assert max(rows) - min(rows) <= 1


@pytest.mark.parametrize("resident,stage", [
    (396, 16384), (21, 64), (5, 64), (3, 32), (16, 4096)])
def test_plan_copies_gather_like_index_select(resident, stage):
    """The copies, executed on the bytes of a small bf16 bank with repeated
    indices (the bank row of each copy read from idx at its output row),
    give index_select's output bit for bit, where rows are cut into shares
    (resident 396, 21 and 16 for 7 rows) and where blocks take whole rows
    (resident 5 and 3)."""
    bank = probe.make_bank(9, 3, 2056, torch.bfloat16, torch.device("cpu"))
    idx = torch.tensor([8, 8, 8, 0, 1, 2, 3], dtype=torch.int32)
    row_bytes = 3 * 2056 * 2
    src = bank.view(torch.uint8).reshape(9, row_bytes)
    out = torch.zeros(len(idx), row_bytes, dtype=torch.uint8)
    plan = bank_gather_plan(len(idx), row_bytes, resident, stage)
    for b in range(plan.blocks):
        for row, off, n in block_copies(plan, len(idx), row_bytes, stage, b):
            out[row, off:off + n] = src[idx[row], off:off + n]
    want = bank_gather_reference(bank, idx)
    assert torch.equal(out.view(torch.bfloat16).reshape(want.shape), want)


@pytest.mark.parametrize("fault", sorted(probe.FAULTS))
def test_probe_faults_patch_the_kernel_source(tmp_path, fault):
    """Each planted fault of the probe applies exactly once to P1's source
    as it is, in a copy that holds chip_smoke.py."""
    from flash_vstream_tpu_torch.scripts.probe_int4_k6 import make_variant
    d = make_variant(fault, tmp_path, probe.SRC, probe.FAULTS)
    cu = (d / "flash_vstream_tpu_torch" / probe.SRC).read_text()
    base = (ROOT / "flash_vstream_tpu_torch" / probe.SRC).read_text()
    assert cu != base and (d / "chip_smoke.py").exists()


@pytest.mark.parametrize("name", sorted(set(probe.SWEEP) - {"base"}))
def test_probe_sweep_patches_the_kernel_source(tmp_path, name):
    """Each copy of the probe's sweep applies its edits exactly once to
    P1's source as it is: another ring or the L2 policy."""
    from flash_vstream_tpu_torch.scripts.probe_int4_k6 import make_variant
    d = make_variant(name, tmp_path, probe.SRC, probe.SWEEP)
    cu = (d / "flash_vstream_tpu_torch" / probe.SRC).read_text()
    base = (ROOT / "flash_vstream_tpu_torch" / probe.SRC).read_text()
    assert cu != base
    for _, new in probe.SWEEP[name]:
        assert new in cu


def test_probe_card_readings_refuse_the_cpu():
    for flag in ("--fixed", "--sweep", "--faults"):
        with pytest.raises(ValueError, match="need the card"):
            probe.main(["--device", "cpu", "--t", "8", "--k", "2", "--p",
                        "2", "--d", "8", "--iters", "1", flag])


def test_plan_refuses_what_the_kernel_does_not_take():
    for bad in ((0, 1008, 396), (3, 1000, 396), (3, 8, 396), (3, 1008, 0)):
        with pytest.raises(ValueError, match="bank_gather_plan"):
            bank_gather_plan(*bad, 16384)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (sm_90a)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,idx", [
    ((64, 64, 1280), [3, 63, 0, 3, 17]),     # repeated index, 160/320 KB rows
    ((50, 7, 72), [49]),                     # K 1, rows of 1,008/2,016 B
    ((9, 3, 2056), [8, 8, 8, 0, 1, 2, 3]),   # rows not a multiple of 16 KB
    # the probe's rows, 13 shares a row at 3 blocks an SM
    ((40, 256, 1280), [39, 0, 7, 7, 21] * 6),
    # K 5,000 of 64-byte rows: K above the resident blocks, whole rows a
    # block
    ((64, 2, 16), [(i * 7) % 64 for i in range(5000)]),
    # K 1,000 of 40/80 KB rows (3/5 stages a row): whole rows a block, the
    # ring's stages carried from row to row
    ((40, 16, 1280), [(i * 7) % 40 for i in range(1000)]),
])
def test_kernel_matches_reference_on_card(cuda, dtype, shape, idx):
    g = torch.Generator(device=cuda).manual_seed(0)
    bank = torch.randn(*shape, generator=g, device=cuda).to(dtype)
    idx = torch.tensor(idx, dtype=torch.int32, device=cuda)
    n0 = bank_gather_cuda.launches
    got = bank_gather(bank, idx)
    torch.cuda.synchronize()
    assert bank_gather_cuda.launches == n0 + 1
    assert torch.equal(got, bank_gather_reference(bank, idx))


# torch.profiler sessions in a process of their own, each over one call of
# P1 or K2, in the order given ("graph": P1 captured in a CUDA graph and
# replayed): per session [step, device kernels seen, the step's kernel
# among them], as one JSON list; then P1's last launched grid and the
# resident blocks
_SESSIONS = r"""
import json, sys, torch, chip_smoke as cs
from flash_vstream_tpu_torch.kernels.bank_gather import (bank_gather_cuda,
                                                         card_ring)
from flash_vstream_tpu_torch.kernels.gather_rows import gather_rows_cuda
dev = torch.device("cuda", 0)
bank = torch.zeros(40, 256, 1280, device=dev, dtype=torch.bfloat16)
idx = torch.arange(30, dtype=torch.int32, device=dev)
fns = {"p1": lambda: bank_gather_cuda(bank, idx),
       "k2": lambda: gather_rows_cuda(bank, idx)}
names = {"p1": "bank_gather_kernel", "k2": "gather_rows"}
for f in fns.values():
    f()
seen = []
for step in sys.argv[1].split(","):
    if step == "graph":
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fns["p1"]()
        g.replay()
        torch.cuda.synchronize()
        continue
    ran = cs._device_kernels(fns[step])
    seen.append([step, sum(ran.values()),
                 int(any(names[step] in k for k in ran))])
print(json.dumps(seen))
print(json.dumps([bank_gather_cuda.grid, card_ring(0)[0]]))
"""


def _sessions(steps):
    res = subprocess.run([sys.executable, "-c", _SESSIONS, steps], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1])


@pytest.mark.gpu
def test_kernel_is_one_wave_and_one_launch_a_call(cuda):
    """One call is one device kernel (torch.profiler, not the wrapper's
    count), and the grid it launched (as the C entry reports it) holds at
    most the blocks the driver says the card holds at once; the grid is
    printed (`-s`). Profiled in a process of its own: in one long pytest
    process, a P1 session earlier left later sessions without device
    events (PERF.md section 7)."""
    [(_, launches, named)], (grid, resident) = _sessions("p1")
    print(f"P1 plan at 30 x 655,360 B: grid {grid}, resident {resident}")
    assert launches == 1 and named
    assert grid[0] * grid[1] <= resident


@pytest.mark.gpu
@pytest.mark.parametrize("steps", ["k2,k2", "p1,k2,p1", "k2,graph,k2,p1",
                                   "p1,graph,k2,p1,k2"])
def test_profiler_sessions_after_p1_see_device_events(cuda, steps):
    """Every torch.profiler session of one process sees its one kernel,
    whatever ran before it: P1's sessions, P1 in a CUDA graph, K2's."""
    for step, launches, named in _sessions(steps)[0]:
        assert launches == 1 and named, (steps, step)


@pytest.mark.gpu
def test_kernel_raises_instead_of_falling_back(cuda):
    bank = torch.zeros(4, 3, 5, device=cuda, dtype=torch.bfloat16)  # 30 B rows
    with pytest.raises(ValueError, match="multiple of 16"):
        bank_gather(bank, torch.zeros(1, dtype=torch.int32, device=cuda))
    bank = torch.zeros(4, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        bank_gather(bank, torch.zeros(1, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="contiguous int32"):
        bank_gather(bank, torch.zeros(4, 2, dtype=torch.int32,
                                      device=cuda)[:, 0])
