"""P1 (bank gather by bulk copies): the port's plain version against the
Pallas gather run in interpret mode and against `jnp.take`, the DAM-gather
probe's routes against each other, and the CUDA kernel against the plain
version on a card. A gather moves bits, so every comparison is exact.

The probe's own Pallas kernel (scripts/probe_bank_gather.py:81) is defined
inside its `main()`; `flash_vstream_tpu.kernels.gather_rows._pallas_gather`
has the same body and grid spec, so the interpret-mode check runs that.

The machine with the card has no JAX, so JAX loads in a fixture; there the
card tests run alone:
    python -m pytest --noconftest -m gpu tests/test_torch_bank_gather.py
"""
import numpy as np
import pytest
import torch

from flash_vstream_tpu_torch.kernels.bank_gather import (
    bank_gather, bank_gather_cuda, bank_gather_reference)
from flash_vstream_tpu_torch.scripts import probe_bank_gather as probe

torch.set_num_threads(1)


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


@pytest.mark.gpu
def test_kernel_raises_instead_of_falling_back(cuda):
    bank = torch.zeros(4, 3, 5, device=cuda, dtype=torch.bfloat16)  # 30 B rows
    with pytest.raises(ValueError, match="multiple of 16"):
        bank_gather(bank, torch.zeros(1, dtype=torch.int32, device=cuda))
    bank = torch.zeros(4, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        bank_gather(bank, torch.zeros(1, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="65535"):
        bank_gather(bank, torch.zeros(65536, dtype=torch.int32, device=cuda))
