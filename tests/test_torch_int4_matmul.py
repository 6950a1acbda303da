"""K6 (int4 decode matvec): the port's plain version against the Pallas
kernel in interpret mode, the gate against JAX's, and the CUDA kernel
against the plain version on a card.

Both branches of the arithmetic are covered: B = 1 (bias and scales on the
block partial sums) and B > 1 (per-element bf16 dequantization), with scale
block counts nb 2, 4 and 28, so the high nibbles' blocks (nb/2 .. nb-1)
differ from the low ones'. The plain version and the interpret-mode kernel
both sum in f32 in other orders: rtol 1e-5 of the output's max.

The machine with the card has no JAX, so JAX loads in a fixture; there the
card tests run alone:
    python -m pytest --noconftest -m gpu tests/test_torch_int4_matmul.py
"""
import numpy as np
import pytest
import torch

from flash_vstream_tpu_torch.kernels.int4_matmul import (
    int4_matmul_cuda, int4_matmul_reference, int4_matmul_supported)
from flash_vstream_tpu_torch.weights.quantize import (
    QuantWeight4, dequantize_weight4, quantize_weight4)

torch.set_num_threads(1)

# (din, block) -> nb: 256/128 -> 2, 512/128 -> 4, 896/32 -> 28
NB_CASES = {2: (256, 128), 4: (512, 128), 28: (896, 32)}


@pytest.fixture(scope="module")
def jax_int4():
    """The JAX kernel module and quantizer."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from flash_vstream_tpu.kernels import int4_matmul as module
    from flash_vstream_tpu.weights.quantize import quantize_weight4 as jq4
    return module, jq4, jnp, pltpu


def _case(B, nb, dout, seed=0):
    din, block = NB_CASES[nb]
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(din, dout)).astype(np.float32)
    x = rng.normal(size=(B, din)).astype(np.float32)
    return w, x, block


@pytest.mark.parametrize("nb", [2, 4, 28])
@pytest.mark.parametrize("B", [1, 8, 32])
def test_reference_matches_pallas_interpret(jax_int4, B, nb):
    module, jq4, jnp, pltpu = jax_int4
    w, x, block = _case(B, nb, 384)
    qw = jq4(jnp.asarray(w), block=block)
    assert qw.scale.shape[0] == nb
    assert module.int4_matmul_supported(B, qw.q4.shape[0], nb, 384)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(module.int4_matmul(
            jnp.asarray(x).astype(jnp.bfloat16), qw.q4, qw.scale,
            out_dtype=jnp.float32))
    got = int4_matmul_reference(torch.from_numpy(x),
                                torch.from_numpy(np.array(qw.q4)),
                                torch.from_numpy(np.array(qw.scale)),
                                torch.float32)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max())


def test_reference_bf16_output_matches_pallas_interpret(jax_int4):
    module, jq4, jnp, pltpu = jax_int4
    w, x, block = _case(1, 4, 256, seed=1)
    qw = jq4(jnp.asarray(w), block=block)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(module.int4_matmul(
            jnp.asarray(x).astype(jnp.bfloat16), qw.q4, qw.scale),
            np.float32)
    got = int4_matmul_reference(torch.from_numpy(x),
                                torch.from_numpy(np.array(qw.q4)),
                                torch.from_numpy(np.array(qw.scale)))
    assert got.dtype == torch.bfloat16
    # bf16 outputs of f32 sums in another order: one bf16 ulp
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-3)


def test_reference_branches_differ_only_by_weight_rounding():
    """B = 1 keeps the scales in f32; B > 1 rounds each weight to bf16: the
    same rows through both branches agree to bf16 weight rounding, and the
    B > 1 branch equals x @ (bf16 dequantized weight) up to the bf16 scale
    rounding."""
    w, x, block = _case(2, 4, 256, seed=2)
    qw = quantize_weight4(torch.from_numpy(w), block=block)
    one = torch.cat([int4_matmul_reference(torch.from_numpy(x[i:i + 1]),
                                           *qw, torch.float32)
                     for i in range(2)])
    two = int4_matmul_reference(torch.from_numpy(x), *qw, torch.float32)
    scale = one.abs().max().item()
    assert (one - two).abs().max().item() < 2e-2 * scale
    assert (one - two).abs().max().item() > 0
    xb = torch.from_numpy(x).to(torch.bfloat16).float()
    deq = xb @ dequantize_weight4(qw, torch.bfloat16).float()
    assert (deq - two).abs().max().item() < 2e-2 * scale


JAX_GATE_CASES = [((1, 1792, 28, 18944), True), ((8, 9472, 148, 3584), True),
                  ((1, 1792, 28, 151936), True), ((64, 1792, 28, 18944), False),
                  ((1, 1792, 7, 18944), False), ((1, 48, 2, 18944), False)]


@pytest.mark.parametrize("args,want", JAX_GATE_CASES)
def test_gate_cases_of_the_jax_tests(args, want):
    assert int4_matmul_supported(*args) is want


def test_gate_equals_jax_over_a_sweep(jax_int4):
    module = jax_int4[0]
    n = 0
    for rows in (1, 2, 8, 32, 33, 64):
        for dh in (16, 32, 48, 64, 96, 128, 1792, 9472):
            for nb in (1, 2, 3, 4, 6, 8, 14, 28, 148):
                for dout in (100, 128, 384, 512, 640, 3584, 152064):
                    assert (int4_matmul_supported(rows, dh, nb, dout)
                            == module.int4_matmul_supported(rows, dh, nb,
                                                            dout))
                    n += 1
    assert n > 2000


def test_cpu_tensors_take_the_plain_version():
    """On the CPU, `dense` over an int4 weight at a shape the gate takes
    runs the plain dequantize + matmul (JAX's path off the TPU) and launches
    nothing; the kernel's launcher refuses CPU tensors rather than running
    anything in their place."""
    from flash_vstream_tpu_torch.models.layers import dense
    w, x, block = _case(1, 4, 128)
    qw = quantize_weight4(torch.from_numpy(w), block=block)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    assert int4_matmul_supported(1, qw.q4.shape[0], qw.scale.shape[0], 128)
    n0 = int4_matmul_cuda.launches
    got = dense(xt, qw)
    assert int4_matmul_cuda.launches == n0
    assert torch.equal(got, xt @ dequantize_weight4(qw, torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        int4_matmul_cuda(xt, *qw)
    assert int4_matmul_cuda.launches == n0


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (sm_90a)")
    return torch.device("cuda")


def _card_case(cuda, B, din, dout, block=128, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randn(din, dout, generator=g, device=cuda)
    x = torch.randn(B, din, generator=g, device=cuda).to(torch.bfloat16)
    return x, quantize_weight4(w, block=block)


# bf16 outputs of f32 sums in another order: 1e-2 of the output's max
CARD_RTOL = 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("B,din,dout", [
    (1, 512, 384), (2, 512, 384), (8, 512, 384), (32, 512, 384),
    (1, 3584, 512), (5, 18944, 256), (1, 896, 128)])
def test_kernel_matches_reference_on_card(cuda, B, din, dout):
    x, qw = _card_case(cuda, B, din, dout, block=32 if din == 896 else 128)
    n0 = int4_matmul_cuda.launches
    got = int4_matmul_cuda(x, *qw)
    torch.cuda.synchronize()
    assert int4_matmul_cuda.launches == n0 + 1
    want = int4_matmul_reference(x, *qw, torch.float32)
    err = (got.float() - want).abs().max().item()
    assert err <= CARD_RTOL * want.abs().max().item(), err


@pytest.mark.gpu
def test_kernel_f32_output_on_card(cuda):
    x, qw = _card_case(cuda, 1, 1024, 256)
    got = int4_matmul_cuda(x, *qw, torch.float32)
    want = int4_matmul_reference(x, *qw, torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.gpu
def test_dense_on_card_launches_k6_at_decode_rows_only(cuda):
    from flash_vstream_tpu_torch.models.layers import dense
    x, qw = _card_case(cuda, 1, 512, 256)
    n0 = int4_matmul_cuda.launches
    dense(x[None], qw)                       # [1, 1, 512]: one decode row
    assert int4_matmul_cuda.launches == n0 + 1
    dense(torch.zeros(1, 64, 512, device=cuda, dtype=torch.bfloat16), qw)
    assert int4_matmul_cuda.launches == n0 + 1   # prefill rows: dequantize


@pytest.mark.gpu
def test_kernel_raises_instead_of_falling_back(cuda):
    x, qw = _card_case(cuda, 1, 512, 256)
    with pytest.raises(ValueError, match="does not take"):
        int4_matmul_cuda(x[:, :256], *qw)                # din mismatch
    with pytest.raises(ValueError, match="does not take"):
        int4_matmul_cuda(torch.zeros(33, 512, device=cuda), *qw)  # 33 rows
    with pytest.raises(ValueError, match="f32"):
        int4_matmul_cuda(x, qw.q4, qw.scale.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        int4_matmul_cuda(x, QuantWeight4(qw.q4.cpu(), qw.scale).q4,
                         qw.scale)


# --- where chip_smoke.py's int4 reference limit sits -----------------------

@pytest.fixture(scope="module")
def int4_case():
    import chip_smoke as cs
    return cs, cs.int4_reference_case()


def test_int4_reference_limit_lies_above_the_arithmetic_difference(int4_case):
    """The kernel's arithmetic (its plain version, f32 scales on the partial
    sums) against the dequantize path (weights rounded to bf16) on the
    small int4 decoder, on the CPU: every logit vector within the limit.
    Run with -s to print the readings."""
    cs, case = int4_case
    want = cs.int4_reference_logits(case, torch.device("cpu"), "dequant")
    got = cs.int4_reference_logits(case, torch.device("cpu"), "plain")
    errs = cs.logit_errors(got, want)
    print("\nplain K6 vs dequantize path:", " ".join(f"{e:.3e}" for e in errs))
    assert max(errs) < cs.INT4_REF_LIMIT
    assert max(errs[1:]) > 0          # the decode steps did take K6's path


def test_int4_reference_limit_lies_below_a_planted_scale_fault(int4_case):
    """The high half's scale blocks off by one (the fault a kernel indexing
    scales by byte row and not by unpacked row would make in part) moves
    the decode steps' logits past the limit."""
    cs, case = int4_case
    want = cs.int4_reference_logits(case, torch.device("cpu"), "dequant")
    got = cs.int4_reference_logits(case, torch.device("cpu"), "fault")
    errs = cs.logit_errors(got, want)
    print("\nplanted fault vs dequantize path:",
          " ".join(f"{e:.3e}" for e in errs))
    assert max(errs) > cs.INT4_REF_LIMIT
