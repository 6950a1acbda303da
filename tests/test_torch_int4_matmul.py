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

from flash_vstream_tpu_torch.kernels import int4_matmul as im
from flash_vstream_tpu_torch.scripts import probe_int4_k6
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


# --- K6's B = 1 design: the plan, the conversion, the fragment map --------

# (dh, nb, dout) at B = 1: the five 7B shapes, then small gate-passing ones
# with odd tile counts and scale blocks of 8, 24 and 16 packed rows (a step
# of 16 rows then spans two blocks where bs % 16 == 8)
PLAN_SHAPES = [(1792, 28, 18944), (9472, 148, 3584), (1792, 28, 3584),
               (1792, 28, 512), (1792, 28, 152064),
               (448, 28, 384), (96, 12, 128), (96, 8, 640), (64, 16, 384),
               (32, 2, 1152), (4096, 2, 128), (9472, 148, 128)]


@pytest.mark.parametrize("sms", [132, 16])
@pytest.mark.parametrize("dh,nb,dout", PLAN_SHAPES)
def test_plan_covers_every_packed_row_once(dh, nb, dout, sms):
    """Every (column, packed row) is one warp's exactly once: column tiles
    of 128 cover dout, and the ranks' warps cover [0, dh) in whole steps
    without overlap; the cluster is within the portable 8 and no block is
    empty."""
    assert int4_matmul_supported(1, dh, nb, dout)
    plan = im._plan(1, dh, nb, dout, sms)
    assert 1 <= plan.split <= im.MAX_CLUSTER
    assert im.MIN_WARPS <= plan.warps <= im.MAX_WARPS
    assert plan.rows % im.STEP_ROWS == 0
    assert plan.split * plan.rows >= dh > (plan.split - 1) * plan.rows
    assert dout % im.WARP_COLS == 0
    seen = np.zeros(dh, np.int64)
    for rank in range(plan.split):
        covered = 0
        for warp in range(plan.warps):
            r = im.warp_rows(plan, dh, rank, warp)
            assert len(r) % im.STEP_ROWS == 0 and r.start % im.STEP_ROWS == 0
            seen[r.start:r.stop] += 1
            covered += len(r)
        assert covered > 0
    assert (seen == 1).all()


@pytest.mark.parametrize("sms", [132, 16])
@pytest.mark.parametrize("dh,nb,dout", PLAN_SHAPES)
def test_plan_runs_most_warps_in_one_wave(dh, nb, dout, sms):
    """Where some plan's warps all fit the card at once (16 an SM), the plan
    is the one of those with the most warps; else it has 4-warp blocks and
    the smallest cluster that fills 85% of its waves, if any does."""
    tiles = dout // im.WARP_COLS
    plan = im._plan(1, dh, nb, dout, sms)
    cap = im.WARPS_PER_SM * sms
    fits = [p for w in (4, 8) for p in im._b1_plans(dh, tiles, w)
            if tiles * p.split * p.warps <= cap]
    if fits:
        assert tiles * plan.split * plan.warps <= cap
        assert plan.split * plan.warps == max(p.split * p.warps
                                              for p in fits)
    else:
        assert plan.warps == 4
        shares = [im.wave_share(p, tiles, sms)
                  for p in im._b1_plans(dh, tiles)[:plan.split]]
        assert shares[-1] >= 0.85 > max(shares[:-1], default=0) or (
            max(shares) < 0.85 and shares[-1] == max(
                im.wave_share(p, tiles, sms)
                for p in im._b1_plans(dh, tiles)))


def test_plan_at_the_7b_shapes_on_132_sms():
    """The plans the sweep on an H100 found fastest (PERF.md)."""
    want = {18944: (3, 4), 3584: (8, 8), 512: (8, 8), 152064: (2, 4)}
    for dh, nb, dout in PLAN_SHAPES[:5]:
        plan = im._plan(1, dh, nb, dout, 132)
        assert (plan.split, plan.warps) == want[dout], (dh, dout)


def _bf16_bits_to_float(bits):
    return torch.tensor(np.array(bits, np.int16)).view(
        torch.bfloat16).float().numpy()


@pytest.mark.parametrize("half", ["low", "high"])
def test_magic_conversion_gives_every_nibble_exactly(half):
    """The source's conversion, emulated bit for bit, on all 256 bytes at
    bytes 0 and 2 of a word: bf16 128 + n for the low (v) or high (v >> 4)
    nibble; taking the 128 off by a bf16 subtract gives n exactly, and in
    the fold (128 + n) x - 136 x = (n - 8) x exactly for integer x."""
    vals = np.arange(256)
    got = []
    for b in vals:
        v = im._byte_perm(int(b) | (int(255 - b) << 8), int((b * 7) % 256),
                          im._sel(0))
        m = im.magic_nibbles(v if half == "low" else v >> 4)
        got.append((m & 0xFFFF, m >> 16))
    got = np.array(got)
    n = vals & 15 if half == "low" else vals >> 4
    n2 = ((vals * 7) % 256) & 15 if half == "low" else ((vals * 7) % 256) >> 4
    lo = _bf16_bits_to_float(got[:, 0].astype(np.int64).astype(np.uint16)
                             .view(np.int16))
    hi = _bf16_bits_to_float(got[:, 1].astype(np.int64).astype(np.uint16)
                             .view(np.int16))
    np.testing.assert_array_equal(lo, 128 + n)
    np.testing.assert_array_equal(hi, 128 + n2)
    # per pair: a bf16 subtract of 128 is exact
    sub = (torch.from_numpy(lo).to(torch.bfloat16)
           - torch.tensor(128.0, dtype=torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(sub, n)
    # in the fold: p - 136 sum x, for integer x (exact in f32)
    x = np.arange(-128, 128, dtype=np.float32)
    np.testing.assert_array_equal(lo * x - 136 * x, (n - 8) * x)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fragment_map_pairs_every_nibble_with_its_own_x(seed):
    """One warp step as the source builds it: the A fragments of every lane
    and tile (`fragment_map`), the B fragments from x at each lane's k rows
    (`fragment_k_rows`: x's low half in column 0, high half in column 1),
    put into the m16n8k16 matrices by the PTX fragment layout and
    multiplied; lane (g, 0)'s c0 and c3 equal, exactly, column 16g + j's
    sums of (128 + n) x over the step's 16 rows for the low and the high
    nibbles: each nibble met its own x once (integer x, exact in f64)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 256, (16, 128), dtype=np.uint8)
    xs = rng.integers(-1000, 1000, (2, 16)).astype(np.float64)
    B = np.zeros((16, 8))
    for lane in range(32):
        g, t4 = lane // 4, lane % 4
        if g < 2:
            rows = im.fragment_k_rows(lane)
            for slot, k in enumerate((2 * t4, 2 * t4 + 1, 2 * t4 + 8,
                                      2 * t4 + 9)):
                B[k, g] = xs[g, rows[slot]]
    for j in range(16):
        A = np.zeros((16, 16))
        for lane in range(32):
            g, t4 = lane // 4, lane % 4
            a = im.fragment_map(w, j, lane)
            for r, (row, k0) in enumerate(((g, 2 * t4), (g + 8, 2 * t4),
                                           (g, 2 * t4 + 8),
                                           (g + 8, 2 * t4 + 8))):
                A[row, k0:k0 + 2] = _bf16_bits_to_float(
                    np.array([a[r] & 0xFFFF, a[r] >> 16], np.uint16)
                    .view(np.int16))
        C = A @ B
        for g in range(8):
            col = w[:, 16 * g + j].astype(np.float64)
            assert C[g, 0] == ((128 + (w[:, 16 * g + j] & 15)) * xs[0]).sum()
            assert C[g + 8, 1] == ((128 + (w[:, 16 * g + j] >> 4))
                                   * xs[1]).sum(), col


def _emulate_fold_kernel(x, q4, scale, plan):
    """csrc/int4_matmul.cu `int4_fold_kernel` step by step in numpy (f32):
    each warp's steps in order, a step's two passes where it spans two
    scale blocks, the fold at each block change with the quad's x sums,
    then the warps summed in warp order and the ranks in rank order. The
    products are taken exactly (f64, then rounded once a step)."""
    dh, dout = q4.shape
    nbh = scale.shape[0] // 2
    bs = dh // nbh
    xf = torch.from_numpy(x).to(torch.bfloat16).float().numpy()[0]
    lo_n = (q4 & 15).astype(np.float64) + 128
    hi_n = (q4 >> 4).astype(np.float64) + 128
    ranks = []
    for rank in range(plan.split):
        warps = []
        for warp in range(plan.warps):
            r = im.warp_rows(plan, dh, rank, warp)
            acc = np.zeros(dout, np.float32)
            if len(r):
                p_lo = np.zeros(dout, np.float32)
                p_hi = np.zeros(dout, np.float32)
                sx = np.zeros((2, 4), np.float32)      # per half, per t4
                cur = r.start // bs

                def fold():
                    q = sx.astype(np.float32)
                    k = [np.float32(136) * ((q[h, 0] + q[h, 1])
                                            + (q[h, 2] + q[h, 3]))
                         for h in range(2)]
                    out = acc + (p_lo - k[0]) * scale[cur]
                    out = out + (p_hi - k[1]) * scale[nbh + cur]
                    return out.astype(np.float32)
                for row0 in range(r.start, r.stop, 16):
                    for blk in range(row0 // bs, (row0 + 8) // bs + 1):
                        if blk != cur:
                            acc = fold()
                            p_lo[:] = 0
                            p_hi[:] = 0
                            sx[:] = 0
                            cur = blk
                        on = [(row0 + 4 * t) // bs == blk for t in range(4)]
                        rows = [row0 + 4 * t + i for t in range(4) if on[t]
                                for i in range(4)]
                        for t in range(4):
                            if on[t]:
                                for h in range(2):
                                    v = xf[h * dh + row0 + 4 * t:
                                           h * dh + row0 + 4 * t + 4]
                                    sx[h, t] += np.float32(
                                        (v[0] + v[1]) + (v[2] + v[3]))
                        p_lo += (xf[rows] @ lo_n[rows]).astype(np.float32)
                        p_hi += (xf[[dh + i for i in rows]]
                                 @ hi_n[rows]).astype(np.float32)
                acc = fold()
            warps.append(acc)
        ranks.append(np.sum(np.stack(warps), axis=0, dtype=np.float32))
    return np.sum(np.stack(ranks), axis=0, dtype=np.float32)


@pytest.mark.parametrize("dh,nb,dout,sms", [
    (448, 28, 128, 132), (96, 12, 256, 132), (96, 8, 128, 16),
    (64, 16, 128, 132), (1792, 28, 128, 8), (256, 4, 384, 132)])
def test_fold_kernel_emulation_matches_reference(dh, nb, dout, sms):
    """The kernel's schedule (plan, warps, steps, passes, folds) emulated
    on the CPU equals the plain version within 1e-5 of the output's max:
    no row is missed or counted twice and each block's bias and scales are
    its own, also where a step spans two scale blocks (bs 8, 24) and where
    a warp starts mid-block."""
    rng = np.random.default_rng(dh + nb)
    w = rng.normal(size=(2 * dh, dout)).astype(np.float32)
    x = rng.normal(size=(1, 2 * dh)).astype(np.float32)
    qw = quantize_weight4(torch.from_numpy(w), block=2 * dh // nb)
    assert qw.scale.shape[0] == nb
    plan = im._plan(1, dh, nb, dout, sms)
    got = _emulate_fold_kernel(x, qw.q4.numpy(), qw.scale.numpy(), plan)
    want = int4_matmul_reference(torch.from_numpy(x), *qw,
                                 torch.float32).numpy()[0]
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("variant", sorted(probe_int4_k6.PATCHES))
def test_probe_k6_variants_patch_the_kernel_source(tmp_path, variant):
    """Every edit of the K6 probe (an alternative, an ablation, planted
    faults) applies exactly once to the kernel source as it is."""
    d = probe_int4_k6.make_variant(variant, tmp_path)
    cu = (d / "flash_vstream_tpu_torch" / probe_int4_k6.SRC).read_text()
    base = (probe_int4_k6.PKG / probe_int4_k6.SRC).read_text()
    assert (cu == base) == (variant == "base")
    assert (d / "chip_smoke.py").exists()


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


# --- K6's B = 1 kernel on the card: every plan branch, bits, refusals ------

# (dh, nb, dout, plan or None for `_plan`'s): one block per tile, clusters
# of 2, 7 and 8, 4 to 8 warps, warps left without rows, scale blocks of 8
# and 24 packed rows (steps spanning two blocks), a rank starting mid-block
CARD_PLANS = [
    (1792, 28, 18944, None), (9472, 148, 3584, None), (1792, 28, 3584, None),
    (1792, 28, 512, None), (1792, 28, 152064, None),
    (448, 28, 384, None), (96, 8, 640, None), (64, 16, 384, None),
    (1792, 28, 1280, im.Int4Plan(1, 8, 1792)),
    (1792, 28, 1280, im.Int4Plan(1, 4, 1792)),
    (1792, 28, 1280, im.Int4Plan(7, 5, 256)),
    (1792, 28, 1280, im.Int4Plan(8, 8, 240)),
    (96, 8, 128, im.Int4Plan(2, 8, 48)),
    (64, 16, 128, im.Int4Plan(4, 4, 16)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dh,nb,dout,plan", CARD_PLANS)
def test_b1_kernel_matches_reference_at_every_plan_on_card(cuda, dh, nb,
                                                           dout, plan):
    """K6 at B = 1 within K6_TOL (chip_smoke.py's 1e-2 of the output's
    max) of its plain version, one launch, at the 7B shapes and every plan
    branch; the same bits from two runs."""
    g = torch.Generator(device=cuda).manual_seed(dh + dout)
    w = torch.randn(2 * dh, dout, generator=g, device=cuda)
    x = torch.randn(1, 2 * dh, generator=g, device=cuda).to(torch.bfloat16)
    qw = quantize_weight4(w, block=2 * dh // nb)
    assert qw.scale.shape[0] == nb
    n0 = int4_matmul_cuda.launches
    got = int4_matmul_cuda(x, *qw, plan=plan)
    again = int4_matmul_cuda(x, *qw, plan=plan)
    torch.cuda.synchronize()
    assert int4_matmul_cuda.launches == n0 + 2
    want = int4_matmul_reference(x, *qw, torch.float32)
    err = (got.float() - want).abs().max().item()
    assert torch.isfinite(got).all()
    assert err <= CARD_RTOL * want.abs().max().item(), err
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_b1_kernel_is_bit_identical_across_runs_and_plans(cuda):
    """One launch's result does not depend on the run, and in f32 two plans
    that split the rows differently agree to f32 summation order."""
    x, qw = _card_case(cuda, 1, 3584, 3584)
    outs = [int4_matmul_cuda(x, *qw, torch.float32) for _ in range(5)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    other = int4_matmul_cuda(x, *qw, torch.float32,
                             plan=im.Int4Plan(1, 8, 1792))
    want = int4_matmul_reference(x, *qw, torch.float32)
    scale = want.abs().max().item()
    assert (other - outs[0]).abs().max().item() <= 1e-4 * scale
    assert (outs[0] - want).abs().max().item() <= 1e-4 * scale


@pytest.mark.gpu
def test_c_entry_refuses_a_foreign_plan(cuda):
    """Plans that leave rows uncovered, leave a block empty, take rows that
    are not whole steps, a cluster above 8, warps outside 4-8, or scratch at
    B = 1 are refused before launch, as are B > 1 plans off their 64-row
    passes or without their scratch."""
    from flash_vstream_tpu_torch.kernels import _build
    lib = _build.library()
    x, qw = _card_case(cuda, 1, 512, 256)
    out = torch.empty(1, 256, device=cuda, dtype=torch.bfloat16)
    buf = torch.empty(2, 1, 256, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    dh = 256
    for B, split, warps, rows, part in (
            (1, 1, 8, 240, None), (1, 3, 8, 128, None), (1, 2, 8, 120, None),
            (1, 16, 8, 16, None), (1, 1, 3, 256, None), (1, 1, 9, 256, None),
            (1, 2, 8, 128, buf), (2, 1, 8, 192, None), (2, 2, 8, 128, None),
            (2, 1, 4, 256, None)):
        rc = lib.fvt_int4_matmul(x.data_ptr(), qw.q4.data_ptr(),
                                 qw.scale.data_ptr(),
                                 None if part is None else part.data_ptr(),
                                 out.data_ptr(), 0, B, dh, 256,
                                 qw.scale.shape[0], split, warps, rows,
                                 stream)
        assert rc != 0, (B, split, warps, rows)
    rc = lib.fvt_int4_matmul(x.data_ptr(), qw.q4.data_ptr(),
                             qw.scale.data_ptr(), None, out.data_ptr(), 0, 1,
                             dh, 256, qw.scale.shape[0], 2, 8, 128, stream)
    assert rc == 0
