"""K1 (flash attention forward): the port's plain version against the JAX
`xla_attention` and against the Pallas kernel run in interpret mode, and
the CUDA kernel against the plain version on a card.

CPU comparisons run in f32 with atol 1e-5 (the same f32 arithmetic in a
different summation order). The card comparison runs in bf16 with atol
2e-2: both accumulate in f32 from the same bf16 inputs, and the bound
covers bf16 rounding of outputs of size ~1.

The machine with the card has no JAX, so JAX loads in a fixture; there the
card tests run alone:
    python -m pytest --noconftest -m gpu tests/test_torch_flash_attention.py
"""
import numpy as np
import pytest
import torch

from flash_vstream_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_cuda, flash_attention_reference)

torch.set_num_threads(1)
ATOL = 1e-5


@pytest.fixture(scope="module")
def jfa():
    """The JAX kernel module (and jnp as jfa.jnp)."""
    pytest.importorskip("jax")
    from flash_vstream_tpu.kernels import flash_attention
    return flash_attention


def _inputs(seed, B, Hq, Hkv, Sq, Skv, D, segments):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, Sq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32)
    qs = ks = None
    if segments:
        # a -1 run (padded memory slots), a -1 tail, and a q row whose id
        # no key carries (a fully masked row)
        ks = np.zeros((B, Skv), np.int32)
        ks[:, Skv // 3:Skv // 3 + 5] = -1
        ks[:, -3:] = -1
        qs = np.zeros((B, Sq), np.int32)
        qs[:, -3:] = -1
        qs[:, 1] = 7
    return q, k, v, qs, ks


CASES = {
    # name: (B, Hq, Hkv, Sq, Skv, D, causal, segments)
    "noncausal_d80": (2, 4, 4, 33, 33, 80, False, False),
    "causal_d128": (1, 4, 4, 40, 40, 128, True, False),
    "causal_gqa_segments_d128": (2, 8, 2, 37, 37, 128, True, True),
    "gqa_segments_d80": (1, 6, 3, 21, 29, 80, False, True),
    "segments_d64": (2, 2, 1, 16, 16, 64, False, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_xla_attention(jfa, name):
    jnp = jfa.jnp
    B, Hq, Hkv, Sq, Skv, D, causal, seg = CASES[name]
    q, k, v, qs, ks = _inputs(0, B, Hq, Hkv, Sq, Skv, D, seg)
    want = jfa.xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_segment_ids=None if qs is None else jnp.asarray(qs),
        kv_segment_ids=None if ks is None else jnp.asarray(ks))
    t = torch.from_numpy
    got = flash_attention_reference(
        t(q), t(k), t(v), causal=causal,
        q_segment_ids=None if qs is None else t(qs),
        kv_segment_ids=None if ks is None else t(ks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_fully_masked_rows_are_zero():
    q, k, v, qs, ks = _inputs(1, 1, 4, 2, 24, 24, 128, True)
    t = torch.from_numpy
    out = flash_attention(t(q), t(k), t(v), causal=True,
                          q_segment_ids=t(qs), kv_segment_ids=t(ks))
    assert not torch.isnan(out).any()
    # row 1 carries an id no key has; the last 3 rows are -1 padding
    assert torch.equal(out[:, :, 1], torch.zeros_like(out[:, :, 1]))
    assert torch.equal(out[:, :, -3:], torch.zeros_like(out[:, :, -3:]))
    assert out[:, :, 0].abs().max() > 0


@pytest.mark.parametrize("q_offset", [0, 5, 17])
def test_decode_q_offset_matches_xla(jfa, q_offset):
    """Decode against a cache prefix: one query at position q_offset."""
    jnp = jfa.jnp
    rng = np.random.default_rng(q_offset)
    q = rng.normal(size=(1, 4, 1, 128)).astype(np.float32)
    k = rng.normal(size=(1, 2, 24, 128)).astype(np.float32)
    v = rng.normal(size=(1, 2, 24, 128)).astype(np.float32)
    ks = np.zeros((1, 24), np.int32)
    ks[:, 3:6] = -1
    qs = np.zeros((1, 1), np.int32)
    want = jfa.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, q_offset=q_offset,
                             q_segment_ids=jnp.asarray(qs),
                             kv_segment_ids=jnp.asarray(ks))
    t = torch.from_numpy
    got = flash_attention(t(q), t(k), t(v), causal=True, q_offset=q_offset,
                          q_segment_ids=t(qs), kv_segment_ids=t(ks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_bf16_reference_matches_xla_attention(jfa):
    """bf16 inputs: p is rounded to bf16 before the P V product in both."""
    jnp = jfa.jnp
    q, k, v, qs, ks = _inputs(2, 1, 4, 2, 40, 40, 80, True)
    jb = lambda x: jnp.asarray(x, jnp.bfloat16)
    want = jfa.xla_attention(jb(q), jb(k), jb(v), causal=True,
                             q_segment_ids=jnp.asarray(qs),
                             kv_segment_ids=jnp.asarray(ks))
    tb = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    got = flash_attention_reference(tb(q), tb(k), tb(v), causal=True,
                                    q_segment_ids=torch.from_numpy(qs),
                                    kv_segment_ids=torch.from_numpy(ks))
    # one bf16 ulp of the output where the two sum in different orders
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=1e-2)


def _pad(x, axis, mult, value=0):
    pad = (-x.shape[axis]) % mult
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=value)


@pytest.mark.parametrize("name", ["causal_gqa_segments_d128",
                                  "noncausal_d80"])
def test_reference_matches_pallas_interpret(jfa, name):
    """The Pallas kernel itself, run as the JAX tests run it on the CPU,
    fed inputs padded the way the JAX wrapper pads them (S and D to 128)."""
    from jax.experimental.pallas import tpu as pltpu
    jnp = jfa.jnp
    B, Hq, Hkv, Sq, Skv, D, causal, seg = CASES[name]
    q, k, v, qs, ks = _inputs(3, B, Hq, Hkv, Sq, Skv, D, seg)
    qp = _pad(_pad(q, 3, 128), 2, 128)
    kp = _pad(_pad(k, 3, 128), 2, 128)
    vp = _pad(_pad(v, 3, 128), 2, 128)
    if seg:
        qsp, ksp = _pad(qs, 1, 128, -1), _pad(ks, 1, 128, -1)
    elif not causal:
        qsp = _pad(np.zeros((B, Sq), np.int32), 1, 128, -1)
        ksp = _pad(np.zeros((B, Skv), np.int32), 1, 128, -1)
    else:
        qsp = ksp = None
    j = lambda x: None if x is None else jnp.asarray(x)
    with pltpu.force_tpu_interpret_mode():
        want = jfa._pallas_flash(j(qp), j(kp), j(vp), j(qsp), j(ksp),
                                 causal=causal, scale=1.0 / np.sqrt(D),
                                 block_q=128, block_kv=128)
    want = np.asarray(want)[:, :, :Sq, :D]
    t = torch.from_numpy
    got = flash_attention_reference(
        t(q), t(k), t(v), causal=causal,
        q_segment_ids=None if qs is None else t(qs),
        kv_segment_ids=None if ks is None else t(ks))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_reference_on_card(cuda, name):
    B, Hq, Hkv, Sq, Skv, D, causal, seg = CASES[name]
    q, k, v, qs, ks = _inputs(4, B, Hq, Hkv, Sq, Skv, D, seg)
    tb = lambda x: torch.from_numpy(x).to(cuda, torch.bfloat16)
    ti = lambda x: None if x is None else torch.from_numpy(x).to(cuda)
    args = (tb(q), tb(k), tb(v))
    kw = dict(causal=causal, q_segment_ids=ti(qs), kv_segment_ids=ti(ks))
    n0 = flash_attention_cuda.launches
    got = flash_attention(*args, **kw)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == n0 + 1
    want = flash_attention_reference(*args, **kw)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    if seg:
        assert torch.equal(got[:, :, -3:], torch.zeros_like(got[:, :, -3:]))


@pytest.mark.gpu
def test_kernel_raises_instead_of_falling_back(cuda):
    x = torch.zeros(1, 2, 8, 128, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(x, x, x)                       # f32 on the card
    y = torch.zeros(1, 2, 8, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(y, y, y)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [8, 16])
def test_small_head_dims_pad_to_the_kernel(cuda, D):
    """The tiny configs' head dims (ViT 8, decoder 16) run K1 zero-padded to
    64; the result is the plain attention's at the true head_dim."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 4, 40, D, generator=g, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    n0 = flash_attention_cuda.launches
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == n0 + 1
    assert got.shape == q.shape
    want = flash_attention_reference(q, k, v, causal=True)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
