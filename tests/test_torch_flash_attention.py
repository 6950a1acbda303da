"""K1 (flash attention forward): the port's plain version against the JAX
`xla_attention` and against the Pallas kernel run in interpret mode, and
the CUDA kernel against the plain version on a card.

CPU comparisons run in f32 with atol 1e-5 (the same f32 arithmetic in a
different summation order). The card comparison runs in bf16: both
accumulate in f32 from the same bf16 inputs; the whole output within 2e-2
absolute (bf16 rounding of outputs of size ~1) and each row that sees a key
within `ROW_TOL` of its own max, so a late row's small outputs are held too.
The launch plan (`_launch_plan`: q rows per block, blocks, shared bytes) is
held on the CPU; on the card, output and lse are the same bit for bit at
every rows per block the C entry takes.

The machine with the card has no JAX, so JAX loads in a fixture; there the
card tests run alone:
    python -m pytest --noconftest -m gpu tests/test_torch_flash_attention.py
"""
import numpy as np
import pytest
import torch

from flash_vstream_tpu_torch.kernels import flash_attention as fa
from flash_vstream_tpu_torch.scripts import probe_flash_fwd
from flash_vstream_tpu_torch.kernels.flash_attention import (
    ROW_TOL, TILE_CASES, flash_attention, flash_attention_cuda,
    flash_attention_reference)

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


@pytest.mark.parametrize("name", sorted(TILE_CASES))
def test_reference_matches_xla_attention_at_tile_cases(jfa, name):
    """The cases the card holds K1/K3 at (every kind of warp tile), in f32:
    the plain version against `xla_attention`."""
    jnp = jfa.jnp
    B, Hq, Hkv, Sq, Skv, D, causal, q_runs, kv_runs = TILE_CASES[name]
    q, k, v, _, _ = _inputs(5, B, Hq, Hkv, Sq, Skv, D, False)
    qs = fa.segment_ids(q_runs, B, Sq)
    ks = fa.segment_ids(kv_runs, B, Skv)
    want = jfa.xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_segment_ids=jnp.asarray(qs.numpy()),
        kv_segment_ids=jnp.asarray(ks.numpy()))
    t = torch.from_numpy
    got = flash_attention_reference(t(q), t(k), t(v), causal=causal,
                                    q_segment_ids=qs, kv_segment_ids=ks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# the K1/K3 shapes chip_smoke.py times: (B, Hq, Sq, D) -> rows per block
TIMED_PLANS = {
    "prefill": ((1, 28, 3008, 128), 128),
    "train": ((1, 28, 4096, 128), 128),
    "vit_full": ((4, 16, 256, 80), 128),
    "vit_small": ((4, 16, 64, 80), 64),
    "vit_448": ((4, 16, 1024, 80), 128),
}


@pytest.mark.parametrize("name", sorted(TIMED_PLANS))
def test_launch_plan_at_the_timed_shapes(name):
    (B, Hq, Sq, D), rows = TIMED_PLANS[name]
    plan = fa._launch_plan(B, Hq, Sq, D)
    assert plan == fa.FwdPlan(rows, B * Hq * -(-Sq // rows),
                              fa._smem_bytes(rows, D))


@pytest.mark.parametrize("Sq, rows", [(1, 16), (15, 16), (16, 16), (17, 32),
                                      (100, 128), (3008, 128)])
@pytest.mark.parametrize("B, Hq", [(1, 28), (240, 16)])
def test_launch_plan_at_ragged_lengths(B, Hq, Sq, rows):
    """No more rows than Sq needs: a prompt's 28 heads and the training
    ViT's 240 frames x 16 heads alike (Sq <= FILL_MIN_SQ, or the card full
    at 128 rows)."""
    assert fa._launch_plan(B, Hq, Sq, 128).rows_per_block == rows


@pytest.mark.parametrize("B, Hq, Sq, rows", [
    (1, 4, 3008, 64), (1, 28, 300, 64), (1, 1, 3008, 16), (1, 1, 256, 128)])
def test_launch_plan_halves_long_calls_to_fill_the_card(B, Hq, Sq, rows):
    """Above FILL_MIN_SQ a small grid halves its rows until 132 blocks (or
    16 rows); at or below it, it does not."""
    assert fa._launch_plan(B, Hq, Sq, 80).rows_per_block == rows


@pytest.mark.parametrize("B, Hq", [(1, 1), (1, 4), (1, 28), (2, 14), (4, 16),
                                   (240, 16)])
@pytest.mark.parametrize("Sq", [1, 15, 16, 17, 64, 100, 256, 1000, 3008])
@pytest.mark.parametrize("D", [64, 80, 128])
def test_launch_plan_fills_the_card(B, Hq, Sq, D):
    """Rows per block: one the C entry takes; above FILL_MIN_SQ at least
    132 blocks wherever 16-row blocks reach that many, else 16 rows; halved
    no further than needed; q tiles that cover Sq once; shared bytes within
    the opt-in."""
    plan = fa._launch_plan(B, Hq, Sq, D)
    rows = plan.rows_per_block
    assert rows in fa.ROWS_PER_BLOCK
    tiles = -(-Sq // rows)
    assert plan.blocks == B * Hq * tiles and (tiles - 1) * rows < Sq
    if Sq > fa.FILL_MIN_SQ:
        if B * Hq * -(-Sq // 16) >= fa.N_SM:
            assert plan.blocks >= fa.N_SM
        else:
            assert rows == 16
    if rows < 128:      # halved because Sq is short or the grid was small
        assert rows >= Sq or (Sq > fa.FILL_MIN_SQ and
                              B * Hq * -(-Sq // (2 * rows)) < fa.N_SM)
    assert plan.smem_bytes == fa._smem_bytes(rows, D) <= 232_448


def test_launch_plan_takes_a_forced_rows_per_block():
    for rows in fa.ROWS_PER_BLOCK:
        plan = fa._launch_plan(1, 28, 3008, 128, rows)
        assert plan.rows_per_block == rows
        assert plan.blocks == 28 * -(-3008 // rows)
    with pytest.raises(ValueError, match="rows_per_block"):
        fa._launch_plan(1, 28, 3008, 128, 48)
    with pytest.raises(ValueError, match="head_dim"):
        fa._launch_plan(1, 28, 3008, 96)


@pytest.mark.parametrize("variant", sorted(probe_flash_fwd.PATCHES))
def test_probe_variants_patch_the_kernel_source(tmp_path, variant):
    """Every edit of the K1/K3 probe (ablations, dropped alternatives,
    planted faults) applies exactly once to the kernel source as it is, and
    a 2-slot variant's wrapper counts 2 slots in its shared bytes."""
    d = probe_flash_fwd.make_variant(variant, tmp_path)
    cu = (d / "flash_vstream_tpu_torch/kernels/csrc/flash_attention.cu"
          ).read_text()
    base = (probe_flash_fwd.PKG / probe_flash_fwd.SRC).read_text()
    assert (cu == base) == (variant == "base")
    py = (d / "flash_vstream_tpu_torch/kernels/flash_attention.py").read_text()
    slots = 2 if "constexpr int kStages = 2;" in cu else 3
    assert f"STAGES = {slots} " in py
    assert (d / "chip_smoke.py").exists()


@pytest.mark.parametrize("message, caught", [
    ("AssertionError: K1 prefill: max_abs_err 1.562e-02 (limit 2e-2), row err"
     " 1.267e-01 (limit 2e-02 of the row's max) or non-finite output", True),
    ("AssertionError: K1 prefill: max_abs_err 5.908e-02 (limit 2e-2), row err"
     " 6.269e-01 (limit 2e-02 of the row's max) or non-finite output", False),
    ("AssertionError: K1 prefill: a row that sees no key is not 0", False)])
def test_probe_counts_a_fault_caught_by_the_row_limit_alone(message, caught):
    """A planted fault counts only if the absolute bound would pass it."""
    assert probe_flash_fwd.caught_by_row(message) is caught


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


def _assert_close_by_row(got, want, q, k, kw):
    """The whole output within 2e-2; each row that sees a key within ROW_TOL
    of its own max |want|; each row that sees none exactly 0."""
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs()
    assert err.max().item() <= 2e-2
    seen = fa._visible(q, k, kw.get("causal", False),
                       kw.get("q_segment_ids"), kw.get("kv_segment_ids")
                       )[:, 0, 0].any(-1)[:, None].expand(-1, q.shape[1], -1)
    row_scale = want.float().abs().amax(-1).clamp_min(1e-30)
    assert (err.amax(-1) / row_scale)[seen].max().item() <= ROW_TOL
    assert not got[~seen].any()


def _case_inputs(dev, name):
    """A CASES or TILE_CASES entry as bf16 card tensors and keywords."""
    tb = lambda x: torch.from_numpy(x).to(dev, torch.bfloat16)
    if name in TILE_CASES:
        B, Hq, Hkv, Sq, Skv, D, causal, q_runs, kv_runs = TILE_CASES[name]
        q, k, v, _, _ = _inputs(6, B, Hq, Hkv, Sq, Skv, D, False)
        return (tb(q), tb(k), tb(v)), dict(
            causal=causal, q_segment_ids=fa.segment_ids(q_runs, B, Sq, dev),
            kv_segment_ids=fa.segment_ids(kv_runs, B, Skv, dev))
    B, Hq, Hkv, Sq, Skv, D, causal, seg = CASES[name]
    q, k, v, qs, ks = _inputs(4, B, Hq, Hkv, Sq, Skv, D, seg)
    ti = lambda x: None if x is None else torch.from_numpy(x).to(dev)
    return (tb(q), tb(k), tb(v)), dict(causal=causal, q_segment_ids=ti(qs),
                                       kv_segment_ids=ti(ks))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES) + sorted(TILE_CASES))
def test_kernel_matches_reference_on_card(cuda, name):
    args, kw = _case_inputs(cuda, name)
    n0 = flash_attention_cuda.launches
    got = flash_attention(*args, **kw)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == n0 + 1
    want = flash_attention_reference(*args, **kw)
    _assert_close_by_row(got, want, args[0], args[1], kw)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(TILE_CASES))
def test_k3_matches_reference_on_card(cuda, name):
    """K3's out and lse at the tile cases: lse within 1e-3, -inf exactly
    where the plain version has it."""
    args, kw = _case_inputs(cuda, name)
    out, lse = fa.flash_attention_fwd_lse_cuda(*args, **kw)
    p_out, p_lse = fa.flash_attention_fwd_lse_reference(*args, **kw)
    torch.cuda.synchronize()
    _assert_close_by_row(out, p_out, args[0], args[1], kw)
    fin = torch.isfinite(p_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    assert (lse[~fin] == float("-inf")).all()
    assert (lse[fin] - p_lse[fin]).abs().max().item() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES) + sorted(TILE_CASES))
def test_output_bit_identical_across_rows_per_block(cuda, name):
    """K3's out and lse (K1 is the same kernel without the lse pointer) at
    every rows per block the C entry takes: the same bits as the plan's."""
    args, kw = _case_inputs(cuda, name)
    want, want_lse = fa.flash_attention_fwd_lse_cuda(*args, **kw)
    for rows in fa.ROWS_PER_BLOCK:
        lse = torch.empty_like(want_lse)
        out, _ = fa._launch_fwd(*args, lse, kw["causal"], kw["q_segment_ids"],
                                kw["kv_segment_ids"], None, "test",
                                rows_per_block=rows)
        k1, _ = fa._launch_fwd(*args, None, kw["causal"],
                               kw["q_segment_ids"], kw["kv_segment_ids"],
                               None, "test", rows_per_block=rows)
        torch.cuda.synchronize()
        assert torch.equal(out, want) and torch.equal(k1, want), rows
        assert torch.equal(lse, want_lse), rows


@pytest.mark.gpu
def test_c_entry_refuses_a_plan_it_does_not_take(cuda):
    """Rows per block outside {16, 32, 64, 128}, or shared bytes other than
    the kernel's own, are refused before launch."""
    from flash_vstream_tpu_torch.kernels import _build
    q = torch.zeros(1, 2, 64, 64, device=cuda, dtype=torch.bfloat16)
    out = torch.empty_like(q)
    lib = _build.library()
    for rows, smem in ((48, fa._smem_bytes(48, 64)),
                       (64, fa._smem_bytes(64, 64) + 16)):
        rc = lib.fvt_flash_attention_fwd(
            q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(), None,
            None, None, *q.stride()[:3], *q.stride()[:3], *q.stride()[:3],
            *out.stride()[:3], 1, 2, 64, 64, 2, 64, 0, rows, smem, 0.125,
            torch.cuda.current_stream(cuda).cuda_stream)
        assert rc != 0, (rows, smem)


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
    _assert_close_by_row(got, want, q, k, dict(causal=True))
