"""K2 (row gather): the port's plain version against the Pallas kernel in
interpret mode and against `jnp.take`, and the CUDA kernel against the plain
version on a card. A gather moves bits, so every comparison is exact.

The machine with the card has no JAX, so JAX loads in a fixture; there the
card tests run alone:
    python -m pytest --noconftest -m gpu tests/test_torch_gather_rows.py
"""
import numpy as np
import pytest
import torch

from flash_vstream_tpu_torch.kernels.gather_rows import (
    gather_rows, gather_rows_batched, gather_rows_batched_reference,
    gather_rows_cuda, gather_rows_reference)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jgr():
    """The JAX kernel module (and jnp as jgr.jnp)."""
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
    got = gather_rows(tb, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_take(jgr, dtype):
    jnp = jgr.jnp
    jb, tb, idx = _case(jnp, dtype)
    want = np.asarray(jnp.take(jb, jnp.asarray(idx), axis=0), np.float32)
    got = gather_rows_reference(tb, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.float().numpy(), want)


def _batched_case():
    rng = np.random.default_rng(1)
    bank = rng.normal(size=(3, 10, 4, 8)).astype(np.float32)
    idx = np.array([[9, 0, 4], [2, 2, 7], [0, 9, 5]], np.int32)
    return bank, idx


@pytest.mark.parametrize("bank_batched", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_reference_matches_vmap_rule(jgr, bank_batched, dtype):
    """The multi-stream form against JAX's gather_rows under jax.vmap (its
    custom_vmap rule): N banks with N index rows, and one bank shared by
    N index rows."""
    import jax
    jnp = jgr.jnp
    bank, idx = _batched_case()
    if not bank_batched:
        bank = bank[0]
    jb = jnp.asarray(bank, dtype)
    want = jax.vmap(jgr.gather_rows, in_axes=(0 if bank_batched else None,
                                              0))(jb, jnp.asarray(idx))
    tb = torch.from_numpy(bank).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    got = gather_rows_batched(tb, torch.from_numpy(idx))
    assert got.shape == (3, 3, 4, 8)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (sm_90a)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_reference_on_card(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    bank = torch.randn(64, 64, 1280, generator=g, device=cuda).to(dtype)
    idx = torch.tensor([3, 63, 0, 3, 17], dtype=torch.int32, device=cuda)
    n0 = gather_rows_cuda.launches
    got = gather_rows(bank, idx)
    torch.cuda.synchronize()
    assert gather_rows_cuda.launches == n0 + 1
    assert torch.equal(got, gather_rows_reference(bank, idx))


@pytest.mark.gpu
def test_kernel_raises_instead_of_falling_back(cuda):
    bank = torch.zeros(4, 3, 5, device=cuda, dtype=torch.bfloat16)  # 30 B rows
    with pytest.raises(ValueError, match="multiple of 16"):
        gather_rows(bank, torch.zeros(1, dtype=torch.int32, device=cuda))
    bank = torch.zeros(4, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        gather_rows(bank, torch.zeros(1, dtype=torch.int64, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("bank_batched", [True, False])
def test_batched_kernel_is_one_launch_on_card(cuda, bank_batched):
    """N streams' rows in one K2 launch over the bank viewed as [N * T, P,
    D], bit for bit the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(1)
    shape = (4, 32, 16, 1280) if bank_batched else (32, 16, 1280)
    bank = torch.randn(*shape, generator=g, device=cuda).to(torch.bfloat16)
    idx = torch.randint(0, 32, (4, 6), generator=g, device=cuda,
                        dtype=torch.int32)
    n0 = gather_rows_cuda.launches
    got = gather_rows_batched(bank, idx)
    torch.cuda.synchronize()
    assert gather_rows_cuda.launches == n0 + 1
    assert torch.equal(got, gather_rows_batched_reference(bank, idx))


@pytest.mark.gpu
def test_batched_kernel_raises_on_bad_input(cuda):
    bank = torch.zeros(2, 4, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="N = 3"):
        gather_rows_batched(bank, torch.zeros(3, 1, dtype=torch.int32,
                                              device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        gather_rows_batched(bank.transpose(2, 3), torch.zeros(
            2, 1, dtype=torch.int32, device=cuda))
