"""P2 (frame-local attention, whole-row softmax): the port's plain version
against the probe's Pallas body run in interpret mode and against the JAX
`xla_attention`, and the CUDA kernel against the plain version on a card.

The Pallas body below is copied from scripts/probe_vit_variants.py:219-243:
the probe defines it inside `main()`, so it cannot be imported.

Tolerances: f32 on the CPU, atol 1e-5 (the same f32 arithmetic summed in
another order); bf16, atol 1e-2 and rtol 2^-7 (both round p to bf16 before
P V, from f32 sums that differ in the last bits, so an element of p or of
the output can land one bf16 step apart); the card in bf16, atol 2e-2
as for K1 (f32 sums from the same bf16 inputs, bf16 outputs of size ~1).

The machine with the card has no JAX, so JAX loads in a fixture; there the
card tests run alone:
    python -m pytest --noconftest -m gpu tests/test_torch_frame_attention.py
"""
import numpy as np
import pytest
import torch

from flash_vstream_tpu_torch.kernels.frame_attention import (
    frame_attention, frame_attention_cuda, frame_attention_reference)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_mods():
    """(jax, jnp, pl, xla_attention)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from flash_vstream_tpu.kernels.flash_attention import xla_attention
    return jax, jnp, pl, xla_attention


def _probe_frame_attn(jax, jnp, pl, q, k, v, head_block):
    """The probe's `framekernel` attention (scripts/probe_vit_variants.py
    :214-243), run with interpret=True."""
    Bq, Hq, Sq, Dh = q.shape
    hb = min(head_block, Hq)
    sc = 1.0 / (Dh ** 0.5)

    def kern(q_ref, k_ref, v_ref, o_ref):
        qq = q_ref[0]
        kk = k_ref[0]
        vv = v_ref[0]
        ss = jax.lax.dot_general(
            qq, kk, (((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32) * sc
        mm = jnp.max(ss, axis=-1, keepdims=True)
        pp = jnp.exp(ss - mm)
        ll = jnp.sum(pp, axis=-1, keepdims=True)
        pp = (pp / ll).astype(qq.dtype)
        oo = jax.lax.dot_general(
            pp, vv, (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32)
        o_ref[0] = oo.astype(o_ref.dtype)

    spec = pl.BlockSpec((1, hb, Sq, Dh), lambda b, h: (b, h, 0, 0))
    return pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct(q.shape, q.dtype),
        grid=(Bq, Hq // hb),
        in_specs=[spec, spec, spec],
        out_specs=spec,
        interpret=True,
    )(q, k, v)


def _qkv(seed, B, H, S, D, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(B, H, S, D)) * scale).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("B,H,S,D,hb", [
    (2, 4, 16, 8, 2), (1, 4, 24, 16, 4), (3, 2, 9, 80, 1)])
def test_reference_matches_pallas_interpret(jax_mods, B, H, S, D, hb):
    jax, jnp, pl, _ = jax_mods
    q, k, v = _qkv(0, B, H, S, D)
    want = _probe_frame_attn(jax, jnp, pl, *map(jnp.asarray, (q, k, v)), hb)
    got = frame_attention(*map(torch.from_numpy, (q, k, v)), head_block=hb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_reference_matches_pallas_interpret_bf16(jax_mods):
    """bf16 inputs: both round p to bf16 before P V; they differ only where
    the f32 sums' last bits put p on the other side of a rounding step."""
    jax, jnp, pl, _ = jax_mods
    q, k, v = _qkv(1, 2, 4, 32, 16)
    want = _probe_frame_attn(
        jax, jnp, pl, *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), 2)
    got = frame_attention_reference(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_xla_attention(jax_mods, dtype):
    _, jnp, _, xla_attention = jax_mods
    q, k, v = _qkv(2, 4, 4, 20, 80, scale=2.0)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(xla_attention(*(jnp.asarray(x, jd) for x in (q, k, v))),
                      np.float32)
    got = frame_attention_reference(
        *(torch.from_numpy(x).to(td) for x in (q, k, v))).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:                  # one bf16 step of the output, 2^-7 relative
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-2)


def test_dispatch_takes_the_plain_version_on_cpu():
    q, k, v = map(torch.from_numpy, _qkv(3, 1, 2, 5, 8))
    n0 = frame_attention_cuda.launches
    torch.testing.assert_close(frame_attention(q, k, v, head_block=2),
                               frame_attention_reference(q, k, v))
    assert frame_attention_cuda.launches == n0
    with pytest.raises(ValueError, match="CUDA"):
        frame_attention_cuda(q, k, v)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (sm_90a)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("S", [64, 256, 1024, 100])
@pytest.mark.parametrize("hb", [1, 2, 8])
def test_kernel_matches_reference_on_card(cuda, S, hb):
    """The ViT's [T, P, H, Dh] -> [T, H, P, Dh] views (strided, no copy) at
    Dh 80; S 1,024 takes the two-pass kernel, 100 a ragged tile."""
    g = torch.Generator(device=cuda).manual_seed(S + hb)
    q, k, v = (torch.randn(2, S, 16, 80, generator=g, device=cuda)
               .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    n0 = frame_attention_cuda.launches
    got = frame_attention(q, k, v, head_block=hb)
    torch.cuda.synchronize()
    assert frame_attention_cuda.launches == n0 + 1
    err = (got.float() - frame_attention_reference(q, k, v).float()).abs()
    assert torch.isfinite(got).all() and err.max().item() <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("D,S", [(64, 256), (128, 128), (128, 300)])
def test_kernel_head_dims_on_card(cuda, D, S):
    g = torch.Generator(device=cuda).manual_seed(D)
    q, k, v = (torch.randn(3, 4, S, D, generator=g, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    got = frame_attention_cuda(q, k, v, head_block=2)
    torch.cuda.synchronize()
    err = (got.float() - frame_attention_reference(q, k, v).float()).abs()
    assert err.max().item() <= 2e-2


@pytest.mark.gpu
def test_kernel_raises_instead_of_falling_back(cuda):
    x = torch.zeros(1, 4, 16, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        frame_attention(x, x, x)
    x = torch.zeros(1, 4, 1025, 80, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="1024"):
        frame_attention(x, x, x)
    x = torch.zeros(1, 6, 16, 80, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_block"):
        frame_attention(x, x, x, head_block=4)
    with pytest.raises(ValueError, match="bfloat16"):
        frame_attention(x.float(), x.float(), x.float())
