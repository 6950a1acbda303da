"""P2 (frame-local attention, whole-row softmax): the port's plain version
against the probe's Pallas body run in interpret mode and against the JAX
`xla_attention`, and the CUDA kernel against the plain version on a card.

The Pallas body below is copied from scripts/probe_vit_variants.py:219-243:
the probe defines it inside `main()`, so it cannot be imported.

Tolerances: f32 on the CPU, atol 1e-5 (the same f32 arithmetic summed in
another order); bf16, atol 1e-2 and rtol 2^-7 (both round p to bf16 before
P V, from f32 sums that differ in the last bits, so an element of p or of
the output can land one bf16 step apart); the card in bf16, max |err|
within 1e-2 of the plain output's max |value|: the kernel takes p / l as
p * (1 / l) and exp as ex2.approx, and its bf16 output lands at most one
step from the plain version's, which is at most 2^-7 of the max (an H100
read max |err| 9.8e-4 at 448 px and 2.0e-3 at 224 px: one step).

The launch plan (`_launch_plan`: grid, rows per block, shared bytes,
variant) is plain Python, held on the CPU at every length the card tests
use and at the ViT's P2 shapes.

The machine with the card has no JAX, so JAX loads in a fixture; there the
card tests run alone:
    python -m pytest --noconftest -m gpu tests/test_torch_frame_attention.py
"""
import numpy as np
import pytest
import torch

from flash_vstream_tpu_torch.kernels import frame_attention as fra
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


LENGTHS = (1, 63, 64, 65, 100, 255, 256, 257, 1000, 1024)
HEAD_BLOCKS = (1, 2, 8, 16)


@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("B,H", [(4, 16), (1, 16), (3, 2)])
def test_launch_plan_covers_every_row_once(B, H, S, D):
    """One block per (q tile, head, frame): every (frame, head, query row)
    exactly once, no empty block, the same plan at every head block, rows a
    multiple of 16 (a warp's), threads within the variant's bound, shared
    bytes within the opt-in, one pass over enough 64-key tiles where a
    head's K and V fit and two passes elsewhere."""
    plans = {hb: fra._launch_plan(B, H, S, D, hb)
             for hb in HEAD_BLOCKS if H % min(hb, H) == 0}
    plan = plans[1]
    assert all(p == plan for p in plans.values()), plans
    gx, gy, gz = plan.grid
    R = plan.rows_per_block
    assert (gy, gz) == (H, B) and R % 16 == 0 and 16 <= R <= 128
    assert plan.threads == 2 * R
    assert plan.threads <= (128 if plan.variant.startswith("whole") else 256)
    seen = np.zeros((B, H, S), np.int64)
    for z in range(gz):
        for y in range(gy):
            for x in range(gx):
                rows = slice(x * R, min((x + 1) * R, S))
                assert rows.start < S          # no empty block
                seen[z, y, rows] += 1
    assert (seen == 1).all()
    assert 0 < plan.smem_bytes <= fra.MAX_SMEM
    one_pass = S <= (256 if D <= 80 else 128)
    assert plan.variant.startswith("whole") == one_pass
    if one_pass:
        n = int(plan.variant[5:])
        assert n in (1, 2, 4) and n // 2 * 64 < S <= n * 64


@pytest.mark.parametrize("name,T,S", fra.P2_CASES)
def test_launch_plan_fills_the_card(name, T, S):
    """At the ViT's P2 shapes (16 heads of 80) the grid has at least 132
    blocks (one H100's SMs) at every head block."""
    for hb in HEAD_BLOCKS:
        gx, gy, gz = fra._launch_plan(T, 16, S, 80, hb).grid
        assert gx * gy * gz >= fra.N_SM, (name, hb)


def test_launch_plan_at_the_vit_shapes():
    """The plans chip_smoke.py prints: 224 px (S 256) one pass over 4 key
    tiles in 256 blocks of 64 rows; S 64 one tile in 256 blocks of 16 rows;
    448 px (S 1,024) two passes in 512 blocks of 128 rows, Q plus a 3-stage
    K and V ring at 88-element rows; and the TPU contract on head_block."""
    assert fra._launch_plan(4, 16, 256, 80) == fra.LaunchPlan(
        (4, 16, 4), 64, 2 * 88 * (64 + 8 * 64), "whole4")
    assert fra._launch_plan(4, 16, 64, 80) == fra.LaunchPlan(
        (4, 16, 4), 16, 2 * 88 * (16 + 2 * 64), "whole1")
    assert fra._launch_plan(4, 16, 1024, 80) == fra.LaunchPlan(
        (8, 16, 4), 128, 2 * 88 * (128 + 6 * 64), "tiled")
    with pytest.raises(ValueError, match="head_block"):
        fra._launch_plan(4, 6, 64, 80, 4)


def _rel_err(got, q, k, v):
    """max |got - plain| over max |plain|, after checking got is finite."""
    want = frame_attention_reference(q, k, v).float()
    assert torch.isfinite(got).all()
    return ((got.float() - want).abs().max() / want.abs().max()).item()


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
    assert _rel_err(got, q, k, v) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("D,S", [(64, 256), (128, 128), (128, 300)])
def test_kernel_head_dims_on_card(cuda, D, S):
    g = torch.Generator(device=cuda).manual_seed(D)
    q, k, v = (torch.randn(3, 4, S, D, generator=g, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    got = frame_attention_cuda(q, k, v, head_block=2)
    torch.cuda.synchronize()
    assert _rel_err(got, q, k, v) <= 1e-2


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


def _views(g, dev, B, H, S, D, layout, fill_past=None, extra=0):
    """q, k, v [B, H, S, D] bf16: the ViT's strided [B, S, H, D] ->
    [B, H, S, D] views, or contiguous tensors; with `extra`, sliced to S from
    tensors of S + extra rows whose rows past S hold `fill_past`."""
    out = []
    for _ in range(3):
        shape = (B, S + extra, H, D) if layout == "strided" else (
            B, H, S + extra, D)
        x = torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
        if layout == "strided":
            if extra:
                x[:, S:] = fill_past
            x = x[:, :S].transpose(1, 2)
        else:
            if extra:
                x[:, :, S:] = fill_past
            x = x[:, :, :S]
        out.append(x)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["strided", "contiguous"])
@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("S", LENGTHS)
def test_kernel_matches_reference_at_every_length(cuda, S, D, layout):
    g = torch.Generator(device=cuda).manual_seed(S * 7 + D)
    q, k, v = _views(g, cuda, 2, 4, S, D, layout)
    n0 = frame_attention_cuda.launches
    got = frame_attention_cuda(q, k, v, head_block=2)
    torch.cuda.synchronize()
    assert frame_attention_cuda.launches == n0 + 1
    assert _rel_err(got, q, k, v) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("S", [257, 1000, 1024])
def test_two_pass_variants_on_card(cuda, S, D):
    """The two-pass kernel at 16 heads (the grid of 128-row q tiles) against
    the plain version."""
    g = torch.Generator(device=cuda).manual_seed(S + D)
    q, k, v = _views(g, cuda, 2, 16, S, D, "strided")
    assert fra._launch_plan(2, 16, S, D).variant == "tiled"
    got = frame_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    assert _rel_err(got, q, k, v) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("S", [64, 256, 1024])
def test_output_bit_identical_across_head_blocks(cuda, S):
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = _views(g, cuda, 4, 16, S, 80, "strided")
    outs = [frame_attention_cuda(q, k, v, head_block=hb)
            for hb in HEAD_BLOCKS]
    torch.cuda.synchronize()
    for hb, o in zip(HEAD_BLOCKS[1:], outs[1:]):
        assert torch.equal(o, outs[0]), hb


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["strided", "contiguous"])
@pytest.mark.parametrize("S", [1, 63, 100, 257, 1000])
def test_rows_past_s_are_never_read(cuda, S, layout):
    """q, k, v sliced to S from tensors whose rows past S hold NaN: the
    kernel zero-fills its tiles past S without reading them, so the output
    stays finite and equal to the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(S + 1)
    q, k, v = _views(g, cuda, 2, 4, S, 80, layout, float("nan"), extra=24)
    got = frame_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    assert _rel_err(got, q, k, v) <= 1e-2
