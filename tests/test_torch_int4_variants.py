"""P3 and P4 (the int4 decode-matvec probe's variants): the port's plain
versions against the JAX probe's Pallas bodies run in interpret mode, the
variants against each other and against K6, the probe's chain and entry
points, and the CUDA kernels against their plain versions on a card.

The JAX script is no package: it loads by file path in a fixture. Its
`make_call` runs k_v1..k_v5 and k_v7_unpackonly (v4 with its SMEM scale)
under `force_tpu_interpret_mode`; `bench_bf16` defines v6's pallas_call
inside itself, so `_jax_v6` below copies that spec (:289-304) with
interpret=True.

Tolerance against JAX: one bf16 step of the output (rtol 2^-7), plus 1e-5
of the output's max for f32 sums taken in another order where a column's
sum cancels; v4's int8 x and xs, and v7 (integer sums, two roundings),
are held exactly. On the card: max |kernel - plain| / max |plain| <= 1e-2
(bf16 outputs of f32 sums in another order, K6's limit), v7 exact.

The machine with the card has no JAX; there the card tests run alone:
    python -m pytest --noconftest -m gpu tests/test_torch_int4_variants.py
"""
import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from flash_vstream_tpu_torch.kernels import int4_matmul as im
from flash_vstream_tpu_torch.kernels import int4_variants as iv
from flash_vstream_tpu_torch.kernels.int4_matmul import int4_matmul_reference
from flash_vstream_tpu_torch.scripts import probe_int4_variants as probe

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# (din, dout, blk): nb = din // 128 is 2, 4, 4 and 28
CASES = [(256, 256, 128), (512, 512, 128), (512, 1024, 512),
         (3584, 3584, 512)]
INT4 = ("v1-current", "v2-biasfold", "v3-floor", "v4-int8dot", "v5-u8mask",
        "v7-unpackonly")
JAX_BODIES = {"v1-current": "k_v1", "v2-biasfold": "k_v2", "v3-floor": "k_v3",
              "v4-int8dot": "k_v4", "v5-u8mask": "k_v5",
              "v7-unpackonly": "k_v7_unpackonly"}


@pytest.fixture(scope="module")
def jprobe():
    """(the JAX probe module, jax, jnp, pl, pltpu)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    spec = importlib.util.spec_from_file_location(
        "jax_probe_int4_variants", ROOT / "scripts" / "probe_int4_variants.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module, jax, jnp, pl, pltpu


def _inputs(din, dout, seed=0):
    """x [1, din] f32, q [din/2, dout] uint8 (every byte possible), scale
    [nb, dout] f32, random so a wrong scale block shows."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, din)).astype(np.float32)
    q = rng.integers(0, 256, size=(din // 2, dout), dtype=np.uint8)
    s = rng.uniform(5e-4, 2e-3, size=(din // 128, dout)).astype(np.float32)
    return x, q, s


def _jax_quantize(jnp, x):
    """The JAX chain's v4 quantization (scripts/probe_int4_variants.py
    :198-200)."""
    xs = jnp.max(jnp.abs(x)) / 127.0
    xq = jnp.clip(jnp.round(x / xs), -127, 127).astype(jnp.int8)
    return xq, xs


def _jax_v6(jax, jnp, pl, pltpu, x, w, blk):
    """bench_bf16's pallas_call (scripts/probe_int4_variants.py:289-304)
    with interpret=True."""
    din, dout = w.shape
    return pl.pallas_call(
        functools.partial(k_v6_body, jnp, nb=0),
        grid=(dout // blk,),
        in_specs=[
            pl.BlockSpec((1, din), lambda o: (0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((din, blk), lambda o: (0, o),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, blk), lambda o: (0, o),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, dout), jnp.bfloat16),
        interpret=True,
    )(x, w)


def k_v6_body(jnp, x_ref, w_ref, o_ref, *, nb):
    """k_v6_bf16dot (scripts/probe_int4_variants.py:266-270)."""
    del nb
    o_ref[...] = jnp.dot(x_ref[...], w_ref[...],
                         preferred_element_type=jnp.float32
                         ).astype(o_ref.dtype)


def _run_both(jprobe, name, din, dout, blk, seed=0):
    """(port y, JAX y, port x, JAX x) for a P3 variant on the same bytes."""
    module, _, jnp, _, pltpu = jprobe
    x, q, s = _inputs(din, dout, seed)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    int8_x = name == "v4-int8dot"
    call = module.make_call(getattr(module, JAX_BODIES[name]), din, dout,
                            din // 128, blk, int8_x=int8_x)
    with pltpu.force_tpu_interpret_mode():
        if int8_x:
            xq, xs = _jax_quantize(jnp, xj)
            want = call(xq, xs.reshape(1, 1), jnp.asarray(q), jnp.asarray(s))
        else:
            want = call(xj, jnp.asarray(q), jnp.asarray(s))
    port = probe.make_call(probe.VARIANTS[name][0], din, dout, blk)
    args = probe.quantize_x(xt) if int8_x else (xt,)
    got = port(*args, torch.from_numpy(q), torch.from_numpy(s))
    return got, np.asarray(want, np.float32), xt, xj


def _assert_one_step(got, want):
    np.testing.assert_allclose(got, want, rtol=2 ** -7,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("din,dout,blk", CASES)
@pytest.mark.parametrize("name", INT4)
def test_reference_matches_pallas_interpret(jprobe, name, din, dout, blk):
    got, want, _, _ = _run_both(jprobe, name, din, dout, blk)
    assert got.dtype == torch.bfloat16 and got.shape == (1, dout)
    if name == "v7-unpackonly":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        _assert_one_step(got.float().numpy(), want)


@pytest.mark.parametrize("din,dout,blk", [(256, 256, 128), (512, 1024, 512),
                                          (3584, 3584, 512)])
def test_v6_reference_matches_pallas_interpret(jprobe, din, dout, blk):
    _, jax, jnp, pl, pltpu = jprobe
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, din)).astype(np.float32)
    w = rng.normal(size=(din, dout)).astype(np.float32)
    want = _jax_v6(jax, jnp, pl, pltpu, jnp.asarray(x, jnp.bfloat16),
                   jnp.asarray(w, jnp.bfloat16), blk)
    got = iv.v6_bf16dot(torch.from_numpy(x).to(torch.bfloat16),
                        torch.from_numpy(w).to(torch.bfloat16), blk=blk)
    _assert_one_step(got.float().numpy(), np.asarray(want, np.float32))


def test_v4_quantization_equals_jax_bit_for_bit(jprobe):
    """xq and xs of the chain's per-step quantization, from random x and from
    x whose quotients sit on .5 (round half to even)."""
    _, _, jnp, _, _ = jprobe
    rng = np.random.default_rng(2)
    xs_in = [rng.normal(size=(1, 512)).astype(np.float32) * 3,
             np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]],
                      np.float32)]
    for x in xs_in:
        xq_j, xs_j = _jax_quantize(jnp, jnp.asarray(x, jnp.bfloat16))
        xq_t, xs_t = probe.quantize_x(torch.from_numpy(x).to(torch.bfloat16))
        np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
        assert xs_t.dtype == torch.bfloat16 and xs_t.shape == (1, 1)
        assert (xs_t.view(torch.int16).item()
                == np.asarray(xs_j).reshape(1).view(np.int16)[0])
    assert probe.quantize_x(torch.from_numpy(xs_in[1]).to(
        torch.bfloat16))[0].tolist() == [[127, 0, 2, 2, 0, -2, -2, 4]]


@pytest.mark.parametrize("name", INT4)
def test_one_chained_step_matches_jax(jprobe, name):
    """x = bf16(x + y[:, :din] * 1e-6), port against JAX from the same x and
    bytes; a larger x step (y * 1e-6 is below x's bf16 step) shows that the
    port adds y where JAX does."""
    _, _, jnp, _, _ = jprobe
    din, dout, blk = 512, 512, 128
    got, want, xt, xj = _run_both(jprobe, name, din, dout, blk, seed=3)
    xn_j = np.asarray((xj + jnp.asarray(want, jnp.bfloat16)[:, :din] * 1e-6
                       ).astype(jnp.bfloat16), np.float32)
    xn_t = probe.chain_step(xt, got, din)
    assert xn_t.dtype == torch.bfloat16
    _assert_one_step(xn_t.float().numpy(), xn_j)
    small = xt * 1e-4
    want_small = (small.float() + got[:, :din].float() * 1e-6).numpy()
    np.testing.assert_allclose(
        probe.chain_step(small, got, din).float().numpy(), want_small,
        rtol=2 ** -7, atol=2 ** -8 * np.abs(want_small).max())


def test_variants_relate_as_their_functions():
    """v1, v2 and v5 compute one function, K6's at B 1; v3 is x @ the
    biased nibbles; v4 at xq = x / xs is v2 up to x's quantization; v7 is
    x[0] times the column sums."""
    din, dout = 512, 384
    x, q, s = _inputs(din, dout, seed=4)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    v2 = iv.v2_biasfold(xt, qt, st).float().numpy()
    for fn in (iv.v1_current, iv.v5_u8mask):
        _assert_one_step(fn(xt, qt, st).float().numpy(), v2)
    _assert_one_step(int4_matmul_reference(xt, qt, st).float().numpy(), v2)
    n = torch.cat([qt & 0xF, qt >> 4]).float()
    _assert_one_step(iv.v3_floor(xt, qt, st).float().numpy(),
                     (xt.float() @ n).to(torch.bfloat16).float().numpy())
    v4 = iv.v4_int8dot(*probe.quantize_x(xt), qt, st).float().numpy()
    np.testing.assert_allclose(v4, v2, atol=2e-2 * np.abs(v2).max())
    v7 = iv.v7_unpackonly(xt, qt, st).float()
    np.testing.assert_allclose(v7.numpy(), (xt[0, 0].float() * n.sum(0))
                               .reshape(1, -1).numpy(), rtol=2 ** -7)


def test_dispatch_takes_the_plain_version_on_cpu():
    din, dout = 256, 256
    x, q, s = _inputs(din, dout, seed=5)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    w = xt.new_ones((din, dout))
    before = [k.launches for k in iv.KERNELS]
    for name, (fn, int8_x) in probe.VARIANTS.items():
        if name == "v6-bf16dot":
            args = (xt, w)
        else:
            args = (*probe.quantize_x(xt), qt, st) if int8_x else (xt, qt, st)
        ref = getattr(iv, fn.__name__ + "_reference")(*args)
        assert torch.equal(fn(*args), ref), name
        with pytest.raises(ValueError, match="CUDA"):
            getattr(iv, fn.__name__ + "_cuda")(*args)
    assert [k.launches for k in iv.KERNELS] == before


def test_probe_limits_raise():
    with pytest.raises(ValueError, match="divides dout"):
        probe.make_call(iv.v1_current, 256, 384, 256)
    with pytest.raises(ValueError, match="din <= dout"):
        probe.make_call(iv.v1_current, 512, 256, 128)


def test_probe_main_and_main2_run_on_cpu(capsys):
    small = ["--device", "cpu", "--din", "256", "--dout", "384", "--blk",
             "128", "--iters", "1", "--trials", "1"]
    res = probe.main(small)
    assert list(res) == list(probe.MAIN_VARIANTS)
    assert all(v > 0 for v in res.values())
    res2 = probe.main2(small + ["--which", "v6,v7"])
    assert list(res2) == ["v6-bf16dot", "v7-unpackonly"]
    assert probe.main(small + ["--only", "v4"]).keys() == {"v4-int8dot"}
    lines = capsys.readouterr().out.strip().splitlines()
    names = [ln.split()[0] for ln in lines if "ms/matvec" in ln]
    assert names == [*probe.MAIN_VARIANTS, "v6-bf16dot", "v7-unpackonly",
                     "v4-int8dot"]
    assert all("GB/s stored-weight" in ln for ln in lines if "ms/matvec" in ln)


# --- v1, v2, v3 and v5 on K6's B = 1 kernel: conversions, schedule, load
# depth ---------------------------------------------------------------------

# the four conversions of csrc/int4_b1.cuh: (A fragment mirror, what the
# fragment holds for a nibble n (offset + n), the fold's bias constant,
# whether the fold scales, the variant's plain version in f32)
CONVERSIONS = {
    "PerElement": (iv.per_element_fragment, 0, 8.0, True,
                   iv.v2_biasfold_reference),
    "Packed": (im.fragment_map, 128, 136.0, True, iv.v2_biasfold_reference),
    "Unbiased": (iv.unbiased_fragment, -8, 0.0, True,
                 iv.v1_current_reference),
    "Floor": (im.fragment_map, 128, 128.0, False, iv.v3_floor_reference),
}


def _bf16_bits_to_float(bits):
    return torch.tensor(np.asarray(bits, np.uint16).view(np.int16)).view(
        torch.bfloat16).float().numpy()


@pytest.mark.parametrize("half", ["low", "high"])
def test_per_element_conversion_gives_every_nibble_exactly(half):
    """v2's conversion, emulated as the source does it, on all 256 bytes at
    each byte of a word: the nibble masked out of its byte, converted to
    f32 on its own and rounded into a bf16 pair is n exactly (0..15, both
    halves of the pair); in the fold, n x - 8 x = (n - 8) x exactly for
    integer x."""
    vals = np.arange(256)
    n = vals & 15 if half == "low" else vals >> 4
    other = (vals * 7) % 256
    n2 = other & 15 if half == "low" else other >> 4
    for pos in range(4):
        got = []
        for b, c in zip(vals, other):
            w0, w1 = int(b) << (8 * pos), int(c) << (8 * pos)
            b0, b1 = (w0 >> (8 * pos)) & 0xFF, (w1 >> (8 * pos)) & 0xFF
            if half == "low":
                bits = iv.per_element_pair(b0 & 15, b1 & 15)
            else:
                bits = iv.per_element_pair(b0 >> 4, b1 >> 4)
            got.append((bits & 0xFFFF, bits >> 16))
        got = np.array(got)
        lo = _bf16_bits_to_float(got[:, 0])
        hi = _bf16_bits_to_float(got[:, 1])
        np.testing.assert_array_equal(lo, n)
        np.testing.assert_array_equal(hi, n2)
    x = np.arange(-128, 128, dtype=np.float32)
    np.testing.assert_array_equal(lo * x - 8 * x, (n - 8) * x)


def _bf16_bits(values):
    return torch.tensor(np.asarray(values, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("half", ["low", "high"])
def test_unbiased_conversion_gives_every_nibble_exactly(half):
    """v1's conversion, emulated bit for bit as the source does it, on all
    256 bytes at each byte of a word: byte_perm and lop3 give bf16 128 + n
    (Packed's magic), and that less 136, rounded to bf16, is n - 8 exactly
    (the bits of bf16 n - 8, +0 for n = 8), in both halves of the pair."""
    vals = np.arange(256)
    other = (vals * 7) % 256
    n = vals & 15 if half == "low" else vals >> 4
    n2 = other & 15 if half == "low" else other >> 4
    for pos in range(4):
        got = []
        for b, c in zip(vals, other):
            v01 = im._byte_perm(int(b) << (8 * pos), int(c) << (8 * pos),
                                im._sel(pos))
            magic = im.magic_nibbles(v01 if half == "low" else v01 >> 4)
            bits = iv.unbias_pair(magic)
            got.append((bits & 0xFFFF, bits >> 16))
        got = np.array(got)
        np.testing.assert_array_equal(got[:, 0], _bf16_bits(n - 8))
        np.testing.assert_array_equal(got[:, 1], _bf16_bits(n2 - 8))
        np.testing.assert_array_equal(_bf16_bits_to_float(got[:, 0]), n - 8)


def _check_fragments(conv, seed, ones=False):
    """One warp step of a conversion, on bytes 0-255: the A fragments of
    every lane and tile put into the m16n8k16 matrix by the PTX fragment
    layout, times B from x at each lane's k rows (`ones`: B = 1.0, as
    P3 v7's Ones conversion builds it); lane (g, 0)'s c0 and c3 equal,
    exactly, column 16g + j's sums of (offset + n) x over the step's 16
    rows for the low and the high nibbles."""
    frag, offset = CONVERSIONS[conv][:2]
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 256, (16, 128), dtype=np.uint8)
    w[0, :16] = np.arange(0, 256, 16)      # every high nibble, every low 0
    w[1, :16] = np.arange(16)               # every low nibble
    xs = rng.integers(-1000, 1000, (2, 16)).astype(np.float64)
    if ones:
        xs = np.ones_like(xs)
    B = np.zeros((16, 8))
    for lane in range(8):
        g, t4 = lane // 4, lane % 4
        rows = im.fragment_k_rows(lane)
        for slot, k in enumerate((2 * t4, 2 * t4 + 1, 2 * t4 + 8,
                                  2 * t4 + 9)):
            B[k, g] = xs[g, rows[slot]]
    for j in range(16):
        A = np.zeros((16, 16))
        for lane in range(32):
            g, t4 = lane // 4, lane % 4
            a = frag(w, j, lane)
            for r, (row, k0) in enumerate(((g, 2 * t4), (g + 8, 2 * t4),
                                           (g, 2 * t4 + 8),
                                           (g + 8, 2 * t4 + 8))):
                A[row, k0:k0 + 2] = _bf16_bits_to_float(
                    [a[r] & 0xFFFF, a[r] >> 16])
        C = A @ B
        for g in range(8):
            col = w[:, 16 * g + j].astype(np.float64)
            assert C[g, 0] == ((offset + col % 16) * xs[0]).sum()
            assert C[g + 8, 1] == ((offset + col // 16) * xs[1]).sum()


@pytest.mark.parametrize("seed", [0, 1])
def test_per_element_fragments_pair_every_nibble_with_its_own_x(seed):
    """v2's fragments (n) by `_check_fragments` (Packed's, 128 + n, are held
    the same way in test_torch_int4_matmul.py)."""
    _check_fragments("PerElement", seed)


@pytest.mark.parametrize("seed", [0, 1])
def test_unbiased_fragments_pair_every_nibble_with_its_own_x(seed):
    """v1's fragments (n - 8) by `_check_fragments`."""
    _check_fragments("Unbiased", seed)


def _emulate_b1(x, q4, scale, plan, offset, bias, scaled=True):
    """csrc/int4_b1.cuh `int4_fold_kernel` step by step in numpy (f32), for
    a conversion whose fragments hold offset + n and whose fold takes bias
    sum x off: each warp's steps in order, a step's two passes where it
    spans two scale blocks, the fold at each block change with the quad's
    x sums, then the warps summed in warp order and the ranks in rank
    order. The products are taken exactly (f64, then rounded once a
    step). Unscaled (Floor), dh's rows are one block and the fold, once
    at the end of a warp's rows, adds (p_lo - k_lo) + (p_hi - k_hi)."""
    dh, dout = q4.shape
    nbh = scale.shape[0] // 2
    bs = dh // nbh if scaled else dh
    xf = torch.from_numpy(x).to(torch.bfloat16).float().numpy()[0]
    lo_n = (q4 & 15).astype(np.float64) + offset
    hi_n = (q4 >> 4).astype(np.float64) + offset
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
                    k = [np.float32(bias) * ((sx[h, 0] + sx[h, 1])
                                             + (sx[h, 2] + sx[h, 3]))
                         for h in range(2)]
                    if not scaled:
                        return (acc + ((p_lo - k[0]) + (p_hi - k[1]))
                                ).astype(np.float32)
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


@pytest.mark.parametrize("conv", sorted(CONVERSIONS))
@pytest.mark.parametrize("din,dout,sms", [
    (512, 128, 132), (768, 256, 132), (3584, 128, 132), (3584, 256, 8),
    (1024, 384, 16)])
def test_fold_schedule_emulation_matches_v2_reference(conv, din, dout, sms):
    """The B = 1 kernel's schedule (K6's plan, warps, steps, folds) with
    each conversion, emulated on the CPU on bytes 0-255 with scale blocks
    of 128 packed rows (the probe's nb = din / 128), equals its variant's
    plain version in f32 (v2's function for Packed and PerElement, v1's for
    Unbiased, v3's for Floor) within 1e-5 of the output's max: no row is
    missed or counted twice, each block's bias and scales are its own, also
    where a warp starts mid-block; Floor's one fold a warp loses nothing to
    the f32 cancellation of 128 sum x over the warp's rows."""
    _, offset, bias, scaled, ref = CONVERSIONS[conv]
    x, q, s = _inputs(din, dout, seed=din + dout)
    plan = im._plan(1, din // 2, din // 128, dout, sms)
    got = _emulate_b1(x, q, s, plan, offset, bias, scaled)
    want = ref(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s),
               out_dtype=torch.float32).numpy()[0]
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


# --- v7 on K6's B = 1 kernel (the Ones conversion): Floor's fragments, B =
# 1.0, one fold of 128 x the rows a warp, the epilogue -----------------------

def _ones_epilogue(v, x00):
    """csrc/int4_b1.cuh `Ones::epilogue` then the bf16 store: bf16(bf16(v)
    x[0, 0]) of a column's f32 sum v, as bf16."""
    x00 = torch.tensor(x00).to(torch.bfloat16).float()
    return (torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
            .float() * x00).to(torch.bfloat16)


def _emulate_v7(x, q4, scale, plan):
    """P3 v7 on the B = 1 kernel in numpy: the schedule of `_emulate_b1`
    with Floor's fragments (128 + n), every x 1.0 and one unscaled fold a
    warp of 128 x its rows, then the epilogue with x[0, 0]."""
    sums = _emulate_b1(np.ones_like(x), q4, scale, plan, 128, 128.0,
                       scaled=False)
    return sums, _ones_epilogue(sums, x[0, 0])


@pytest.mark.parametrize("seed", [0, 1])
def test_ones_fragments_sum_every_nibble_once(seed):
    """v7's fragments (Floor's, 128 + n) against B = 1.0 by
    `_check_fragments`: each column's step sums of 128 + n, exactly."""
    _check_fragments("Floor", seed, ones=True)


@pytest.mark.parametrize("din,dout,sms", [
    (512, 128, 132), (768, 256, 132), (3584, 128, 132), (3584, 256, 8),
    (1024, 384, 16)])
def test_ones_schedule_emulation_matches_v7_reference(din, dout, sms):
    """v7's arithmetic on the template, emulated on the CPU on bytes 0-255
    with K6's plan: every warp's and rank's f32 sum is the exact integer
    column sum of n_lo + n_hi (the fold's 128 x rows cancels exactly), and
    the epilogue gives v7's plain version bit for bit."""
    x, q, s = _inputs(din, dout, seed=din + dout)
    plan = im._plan(1, din // 2, din // 128, dout, sms)
    sums, got = _emulate_v7(x, q, s, plan)
    exact = ((q & 15).astype(np.int64) + (q >> 4)).sum(0)
    np.testing.assert_array_equal(sums, exact.astype(np.float32))
    want = iv.v7_unpackonly_reference(torch.from_numpy(x), torch.from_numpy(q),
                                      torch.from_numpy(s))
    assert torch.equal(got[None], want)


@pytest.mark.parametrize("din,dout,blk", CASES)
def test_ones_emulation_matches_pallas_interpret(jprobe, din, dout, blk):
    """v7's arithmetic on the template against the JAX `k_v7_unpackonly`
    in interpret mode on the same bytes and x: equal bit for bit."""
    _, want, _, _ = _run_both(jprobe, "v7-unpackonly", din, dout, blk)
    x, q, s = _inputs(din, dout)
    plan = im._plan(1, din // 2, din // 128, dout, 132)
    got = _emulate_v7(x, q, s, plan)[1].float().numpy()
    np.testing.assert_array_equal(got[None], want)


def test_ones_epilogue_rounds_the_sum_before_the_product():
    """At the probe's shape the epilogue's inner bf16 round changes the
    output: bf16(v x00) differs from bf16(bf16(v) x00) in many columns, so
    chip_smoke's exact limit on v7 catches an epilogue without it."""
    rng = np.random.default_rng(7)
    q = rng.integers(0, 256, (1792, 18944), dtype=np.uint8)
    v = ((q & 15).astype(np.int64) + (q >> 4)).sum(0).astype(np.float32)
    x00 = np.float32(rng.normal())
    rounded = _ones_epilogue(v, x00)
    x00b = torch.tensor(x00).to(torch.bfloat16).float()
    once = (torch.from_numpy(v) * x00b).to(torch.bfloat16)
    assert (rounded != once).sum().item() > 1000


def test_load_depth_maps_groups_to_steps_in_flight():
    """group packed rows a lane loads before the products that use them =
    4 a step x the steps of loads in flight: 4 -> 1 (K6's own), 8 -> 2,
    16 -> 4; any other group is refused."""
    assert {g: iv.load_depth(g) for g in iv.GROUPS} == {4: 1, 8: 2, 16: 4}
    assert all(4 * iv.load_depth(g) == g for g in iv.GROUPS)
    for bad in (0, 2, 6, 12, 32):
        with pytest.raises(ValueError, match="group"):
            iv.load_depth(bad)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (sm_90a)")
    return torch.device("cuda")


def _card_inputs(din, dout, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(1, din, generator=g, device=dev).to(torch.bfloat16)
    q = torch.randint(0, 256, (din // 2, dout), generator=g, device=dev,
                      dtype=torch.uint8)
    s = torch.rand(din // 128, dout, generator=g, device=dev) * 2e-3 + 5e-4
    return x, q, s


@pytest.mark.gpu
@pytest.mark.parametrize("group", iv.GROUPS)
@pytest.mark.parametrize("din,dout,blk", [(3584, 18944, 512), (512, 384, 128),
                                          (256, 256, 128), (1024, 1536, 384),
                                          (3584, 3584, 256)])
@pytest.mark.parametrize("name", list(probe.VARIANTS))
def test_kernel_matches_reference_on_card(cuda, name, din, dout, blk, group):
    x, q, s = _card_inputs(din, dout, cuda, din + dout + blk)
    fn = probe.VARIANTS[name][0]
    if name == "v6-bf16dot":
        args = (x, torch.randn(din, dout, device=cuda).to(torch.bfloat16))
    elif name == "v4-int8dot":
        args = (*probe.quantize_x(x), q, s)
    else:
        args = (x, q, s)
    kernel = getattr(iv, fn.__name__ + "_cuda")
    n0 = kernel.launches
    # the dispatcher at its default group, the kernel itself at the others
    got = (fn(*args, blk=blk) if group == 4
           else kernel(*args, blk=blk, group=group))
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    want = getattr(iv, fn.__name__ + "_reference")(*args).float()
    assert got.shape == (1, dout) and torch.isfinite(got).all()
    err = (got.float() - want).abs().max().item() / want.abs().max().item()
    assert err <= (0.0 if name == "v7-unpackonly" else 1e-2), err


@pytest.mark.gpu
def test_kernels_raise_instead_of_falling_back(cuda):
    x, q, s = _card_inputs(512, 384, cuda, 0)
    with pytest.raises(ValueError, match="divides dout"):
        iv.v2_biasfold(x, q, s, blk=256)
    with pytest.raises(ValueError, match="scale blocks"):
        iv.v1_current(x, q, s[:3])
    with pytest.raises(ValueError, match="bfloat16"):
        iv.v3_floor(x.float(), q, s)
    with pytest.raises(ValueError, match="K6's gate"):
        iv.v3_floor(x, q, s[:3])
    with pytest.raises(ValueError, match="contiguous"):
        iv.v5_u8mask(x, q.t().contiguous().t(), s)
    with pytest.raises(ValueError, match="int8"):
        iv.v4_int8dot(x, x[0, :1], q, s)
    with pytest.raises(ValueError, match="bf16"):
        iv.v6_bf16dot(x.float(), torch.zeros(512, 384, device=cuda))
    with pytest.raises(ValueError, match="CUDA"):
        iv.v7_unpackonly_cuda(x, q.cpu(), s)
    with pytest.raises(ValueError, match="group"):
        iv.v2_biasfold_cuda(x, q, s, group=6)
    with pytest.raises(ValueError, match="group"):
        iv.v6_bf16dot_cuda(x[:, :24], torch.zeros(24, 384, device=cuda,
                                                  dtype=torch.bfloat16),
                           group=16)


# --- v1, v2, v3, v5 and v7 on the card: one launch, the same bits, the
# plans -----------------------------------------------------------------

FOLD = {"v1-current": iv.v1_current_cuda, "v2-biasfold": iv.v2_biasfold_cuda,
        "v7-unpackonly": iv.v7_unpackonly_cuda,
        "v3-floor": iv.v3_floor_cuda, "v5-u8mask": iv.v5_u8mask_cuda}


@pytest.mark.gpu
@pytest.mark.parametrize("din,dout", [(3584, 18944), (512, 384)])
@pytest.mark.parametrize("name", sorted(FOLD))
def test_fold_variants_same_bits_across_runs_and_plans(cuda, name, din,
                                                       dout):
    """v1, v2, v3, v5 and v7 give the same bits from run to run at K6's
    plan and at others (one cluster, 8 warps; two ranks of 4 warps); v5
    gives K6's own bits at each plan (one template, one conversion); v7,
    whose sums are exact integers, its plain version's bits at each plan;
    across plans the f32 sums differ only in order, so the bf16 outputs
    agree within one bf16 step of the output (2^-7 of it) plus 1e-4 of its
    max; v1, v5's function with the unbias per element, agrees with v5 at
    each plan within the same."""
    x, q, s = _card_inputs(din, dout, cuda, din)
    dh = din // 2
    kernel = FOLD[name]
    if name == "v7-unpackonly":
        want = iv.v7_unpackonly_reference(x, q, s).float()
    else:
        ref = (iv.v3_floor_reference if name == "v3-floor"
               else iv.v2_biasfold_reference)
        want = ref(x, q, s, out_dtype=torch.float32)
    scale = want.abs().max().item()
    outs = []
    for plan in (None, im.Int4Plan(1, 8, dh), im.Int4Plan(2, 4, dh // 2)):
        got = [iv._launch_fold(kernel, x, q, s, None, 4, plan)
               for _ in range(3)]
        torch.cuda.synchronize()
        assert all(torch.equal(got[0], o) for o in got[1:]), plan
        if name == "v5-u8mask":
            k6 = im.int4_matmul_cuda(x, q, s, plan=plan or im._plan(
                1, dh, s.shape[0], dout, im._sms(cuda.index)))
            assert torch.equal(got[0], k6), plan
        if name == "v1-current":
            v5 = iv._launch_fold(iv.v5_u8mask_cuda, x, q, s, None, 4,
                                 plan).float()
            assert ((got[0].float() - v5).abs() <= 2 ** -7 * v5.abs()
                    + 1e-4 * scale).all(), plan
        if name == "v7-unpackonly":
            assert torch.equal(got[0].float(), want), plan
        outs.append(got[0].float())
    for o in outs[1:]:
        assert ((o - outs[0]).abs() <= 2 ** -7 * outs[0].abs()
                + 1e-4 * scale).all()
    assert (outs[0] - want).abs().max().item() <= 1e-2 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("group", iv.GROUPS)
@pytest.mark.parametrize("name", sorted(FOLD))
def test_fold_variants_launch_one_kernel_a_call(cuda, name, group):
    """One call is one device kernel, K6's B = 1 kernel, by torch.profiler
    (chip_smoke.py's `_device_kernels`, not the wrapper's count): no
    scratch and no second pass."""
    import chip_smoke as cs
    x, q, s = _card_inputs(3584, 18944, cuda, 1)
    FOLD[name](x, q, s, group=group)
    ran = cs._device_kernels(lambda: FOLD[name](x, q, s, group=group))
    assert sum(ran.values()) == 1, ran
    assert "int4_fold_kernel" in next(iter(ran)), ran


@pytest.mark.gpu
def test_fold_c_entries_refuse_what_they_do_not_take(cuda):
    """The C entries of v1, v2, v3, v5 and v7 refuse, before any launch, a
    depth other than 1, 2 or 4, a plan that does not cover the rows or
    exceeds its sizes, and a dout off the 128-column tiles; the wrappers
    refuse such a dout (outside K6's gate) with a ValueError."""
    from flash_vstream_tpu_torch.kernels import _build
    lib = _build.library()
    x, q, s = _card_inputs(512, 384, cuda, 2)
    out = torch.empty(1, 384, device=cuda, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for fn in (lib.fvt_int4_v1_current, lib.fvt_int4_v2_biasfold,
               lib.fvt_int4_v3_floor, lib.fvt_int4_v5_u8mask,
               lib.fvt_int4_v7_unpackonly):
        def rc(dout=384, split=1, warps=8, rows=256, depth=1):
            return fn(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                      out.data_ptr(), 256, dout, s.shape[0], split, warps,
                      rows, depth, stream)
        assert rc() == 0
        for bad in (dict(depth=3), dict(depth=8), dict(rows=240),
                    dict(split=2, rows=64), dict(warps=9), dict(split=9,
                                                               rows=32),
                    dict(dout=320)):
            assert rc(**bad) != 0, bad
    torch.cuda.synchronize()
    xs, qs, ss = _card_inputs(512, 320, cuda, 3)
    for kernel in FOLD.values():
        with pytest.raises(ValueError, match="multiple of the kernel"):
            kernel(xs, qs, ss, blk=64)


# --- P4 (v6) on its B = 1 bf16 kernel: fragment map, plan, summation order,
# and on the card ----------------------------------------------------------

# chip_smoke.py's P3_SHAPES (din, dout), the shapes the card check runs P4 at
P3_SHAPES = [(3584, 18944), (512, 384), (256, 384)]
K6_TOL = 1e-2     # chip_smoke.py's limit: max |err| over max |plain|


def _bf16_of(values):
    """(bf16 bits as uint16, their f64 values) of f32 values."""
    bits = torch.from_numpy(np.asarray(values, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    return bits, _bf16_bits_to_float(bits).astype(np.float64)


def _p4_step(w_bits, xs):
    """One warp step of P4's kernel from its fragment mirror: every lane's
    A fragments of every tile put into the m16n8k16 matrix by the PTX
    fragment layout, B column 0 from lanes (0, t4)'s x rows (the other
    columns zero). Returns (the 64 columns' sums, lane (g, 0)'s c0 and c2 of
    each tile, in f64; how many times each (row, column) of the step
    entered a product)."""
    sums = np.zeros(64)
    used = np.zeros((16, 64), int)
    B = np.zeros((16, 8))
    for t4 in range(4):
        rows = im.fragment_k_rows(t4)
        for slot, k in enumerate((2 * t4, 2 * t4 + 1, 2 * t4 + 8,
                                  2 * t4 + 9)):
            B[k, 0] = xs[rows[slot]]
    for j in range(4):
        A = np.zeros((16, 16))
        for lane in range(32):
            g, t4 = lane // 4, lane % 4
            a = iv.bf16_fragment(w_bits, j, lane)
            rows = im.fragment_k_rows(lane)
            cols = iv.bf16_fragment_cols(lane, j)
            for r, (arow, k0) in enumerate(((g, 2 * t4), (g + 8, 2 * t4),
                                            (g, 2 * t4 + 8),
                                            (g + 8, 2 * t4 + 8))):
                A[arow, k0:k0 + 2] = _bf16_bits_to_float(
                    [a[r] & 0xFFFF, a[r] >> 16])
                for i in range(2):      # the two rows of the word
                    used[rows[2 * (r // 2) + i], cols[r % 2]] += 1
        C = A @ B
        assert not C[:, 1:].any()       # B's other columns are zero
        for g in range(8):
            lo, hi = iv.bf16_fragment_cols(4 * g, j)
            sums[lo], sums[hi] = C[g, 0], C[g + 8, 0]
    return sums, used


@pytest.mark.parametrize("seed", [0, 1])
def test_p4_fragments_pair_every_element_with_its_own_x(seed):
    """P4's fragment map (`bf16_fragment`, byte_perm 0x5410 / 0x7632 of a
    lane's row words) on one step of integer weights and x (exact in bf16
    and f64): every (row, column) of the step enters exactly one product,
    and lane (g, 0)'s c0 and c2 of tile j equal, exactly, columns 8g + 2j
    and 8g + 2j + 1's sums of w x over the step's 16 rows."""
    rng = np.random.default_rng(seed)
    w_bits, w = _bf16_of(rng.integers(-128, 128, (16, 64)))
    _, xs = _bf16_of(rng.integers(-128, 128, 16))
    sums, used = _p4_step(w_bits, xs)
    assert (used == 1).all()
    np.testing.assert_array_equal(sums, xs @ w)


def test_p4_fragment_products_reproduce_v6_reference():
    """Over all lanes, tiles and steps at a small odd shape (din 144: 9
    steps; dout 192: 3 warp tiles), the fragment map's products reproduce
    x @ w in f64 (to f64 rounding) and, rounded, v6_bf16dot_reference
    within one bf16 step."""
    din, dout = 144, 192
    rng = np.random.default_rng(5)
    w_bits, w = _bf16_of(rng.normal(size=(din, dout)))
    _, x = _bf16_of(rng.normal(size=din))
    got = np.zeros(dout)
    for c0 in range(0, dout, iv.P4_WARP_COLS):
        for r0 in range(0, din, 16):
            got[c0:c0 + 64] += _p4_step(w_bits[r0:r0 + 16, c0:c0 + 64],
                                        x[r0:r0 + 16])[0]
    np.testing.assert_allclose(got, x @ w, rtol=1e-12, atol=1e-12)
    want = iv.v6_bf16dot_reference(
        torch.from_numpy(x[None].astype(np.float32)).to(torch.bfloat16),
        torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16))
    _assert_one_step(torch.from_numpy(got[None]).to(torch.bfloat16)
                     .float().numpy(), want.float().numpy())


@pytest.mark.parametrize("sms", [132, 114, 8])
@pytest.mark.parametrize("din,dout", P3_SHAPES + [(256, 256), (1024, 1536),
                                                  (3584, 3584), (144, 192)])
def test_p4_plan_covers_the_rows(din, dout, sms):
    """`bf16_plan` at every P3 shape (and the card tests' shapes): its
    ranks and warps cover din's rows exactly once in whole 16-row steps,
    no rank is empty, at most 8 ranks a cluster and 8 warps a block, and
    where the plan is one whose grid is resident the card's 16 warps an SM
    hold it; the C entry's `covers` holds."""
    plan = iv.bf16_plan(din, dout, sms)
    tiles = dout // iv.P4_WARP_COLS
    assert 1 <= plan.split <= im.MAX_CLUSTER and plan.warps in iv.P4_WARPS
    assert plan.rows % 16 == 0 and plan.split * plan.rows >= din
    assert (plan.split - 1) * plan.rows < din       # no empty rank
    seen = np.zeros(din, int)
    for rank in range(plan.split):
        rank_rows = 0
        for warp in range(plan.warps):
            r = im.warp_rows(plan, din, rank, warp)
            assert r.start % 16 == 0 and len(r) % 16 == 0
            seen[r.start:r.stop] += 1
            rank_rows += len(r)
        assert rank_rows > 0
    assert (seen == 1).all()
    if plan != (1, 4, din):          # not the many-wave fallback
        assert tiles * plan.split * plan.warps <= im.WARPS_PER_SM * sms
        assert plan.split * plan.warps * 16 <= din


# the clusters of P4's group-4 instance (54 registers) an H100 holds at
# once, by split and warps (cudaOccupancyMaxActiveClusters, read by
# scripts/probe_bf16_b1.py --sweep)
H100_CLUSTERS = {(s, w): n for w, row in (
    (1, (1056, 528, 327, 248, 193, 163, 139, 124)),
    (2, (1056, 528, 327, 248, 193, 163, 139, 124)),
    (4, (1056, 528, 327, 248, 193, 163, 139, 124)),
    (8, (528, 264, 163, 124, 94, 79, 69, 62))) for s, n in enumerate(row, 1)}


def test_p4_plan_at_the_probe_shape():
    """At [3584, 18944] on 132 SMs (296 tiles): under the cap of 128
    registers (16 warps an SM) no resident plan reaches 16 warps an SM, so
    the most warps, clusters of 7 one-warp blocks (2,072 warps, 32 steps
    each); with the H100's own counts at 54 registers, one rank of 8 warps
    (2,368 warps, no cluster), the fastest of the sweep; where the card
    holds fewer clusters than tiles the plan takes the next that is
    resident (2 warps x 3 ranks) rather than a second wave."""
    assert iv.bf16_plan(3584, 18944, 132) == (7, 1, 512)
    assert iv.bf16_plan(3584, 18944, 132,
                        lambda s, w: H100_CLUSTERS[s, w]) == (1, 8, 3584)
    short = lambda split, warps: 290 if (split, warps) == (7, 1) else (  # noqa: E731
        16 // warps * 132 // split)
    assert iv.bf16_plan(3584, 18944, 132, short) == (3, 2, 1200)


def _emulate_p4(x, w, plan):
    """csrc/bf16_b1.cuh `bf16_b1_kernel` in numpy: each warp's steps in
    order into f32 sums (a step's product exact, rounded once), the warps
    summed in warp order and the ranks in rank order, in f32."""
    din, dout = w.shape
    ranks = []
    for rank in range(plan.split):
        warps = []
        for warp in range(plan.warps):
            acc = np.zeros(dout, np.float32)
            r = im.warp_rows(plan, din, rank, warp)
            for r0 in range(r.start, r.stop, 16):
                acc = (acc + (x[r0:r0 + 16] @ w[r0:r0 + 16]).astype(
                    np.float32)).astype(np.float32)
            warps.append(acc)
        v = np.zeros(dout, np.float32)
        for acc in warps:
            v = (v + acc).astype(np.float32)
        ranks.append(v)
    out = ranks[0]
    for v in ranks[1:]:
        out = (out + v).astype(np.float32)
    return out


@pytest.mark.parametrize("din,dout,sms", [(512, 384, 132), (256, 384, 132),
                                          (3584, 192, 132), (1024, 1536, 8),
                                          (3584, 3584, 132)])
def test_p4_summation_emulation_matches_v6_reference(din, dout, sms):
    """The kernel's summation order (steps, warps, ranks in f32) at P4's
    plan, emulated on the CPU, meets x @ w within 1e-5 of the output's max
    in f32, and v6_bf16dot_reference within K6_TOL once rounded to bf16."""
    rng = np.random.default_rng(din + dout)
    _, w = _bf16_of(rng.normal(size=(din, dout)))
    _, x = _bf16_of(rng.normal(size=din))
    plan = iv.bf16_plan(din, dout, sms)
    got = _emulate_p4(x, w, plan)
    exact = x @ w
    scale = np.abs(exact).max()
    assert np.abs(got - exact).max() <= 1e-5 * scale
    want = iv.v6_bf16dot_reference(
        torch.from_numpy(x[None].astype(np.float32)),
        torch.from_numpy(w.astype(np.float32))).float().numpy()[0]
    rounded = torch.from_numpy(got).to(torch.bfloat16).float().numpy()
    assert np.abs(rounded - want).max() <= K6_TOL * np.abs(want).max()


def _p4_inputs(din, dout, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(1, din, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(din, dout, generator=g, device=dev).to(torch.bfloat16)
    return x, w


@pytest.mark.gpu
@pytest.mark.parametrize("group", iv.GROUPS)
@pytest.mark.parametrize("din,dout", P3_SHAPES)
def test_p4_matches_plain_at_p3_shapes(cuda, din, dout, group):
    """P4 at each P3 shape and group within K6_TOL of its plain version,
    its plan's grid resident on the card at once."""
    x, w = _p4_inputs(din, dout, cuda, din + group)
    got = iv.v6_bf16dot_cuda(x, w, group=group)
    torch.cuda.synchronize()
    want = iv.v6_bf16dot_reference(x, w).float()
    assert got.shape == (1, dout) and torch.isfinite(got).all()
    err = (got.float() - want).abs().max().item() / want.abs().max().item()
    assert err <= K6_TOL, err
    depth = iv.load_depth(group)
    plan = iv._p4_plan(din, dout, cuda.index or 0, depth)
    assert iv._card_clusters(plan.split, plan.warps, depth) >= dout // 64, \
        plan


@pytest.mark.gpu
@pytest.mark.parametrize("din,dout", [(3584, 18944), (512, 384)])
def test_p4_same_bits_across_runs_and_plans(cuda, din, dout):
    """P4 gives the same bits from run to run at its plan and at others
    (one rank of 4 warps; 8 ranks of 8 warps; 2 of 2); across plans its f32
    sums differ only in order, so the bf16 outputs agree within one bf16
    step of the output (2^-7 of it) plus 1e-4 of its max."""
    x, w = _p4_inputs(din, dout, cuda, din)
    want = iv.v6_bf16dot_reference(x, w).float()
    scale = want.abs().max().item()
    tiles = dout // 64
    plans = [None] + [im._b1_plans(din, tiles, warps)[split - 1]
                      for split, warps in ((1, 4), (8, 8), (2, 2))]
    outs = []
    for plan in plans:
        got = [iv.v6_bf16dot_cuda(x, w, plan=plan) for _ in range(3)]
        torch.cuda.synchronize()
        assert all(torch.equal(got[0], o) for o in got[1:]), plan
        outs.append(got[0].float())
    for o in outs[1:]:
        assert ((o - outs[0]).abs() <= 2 ** -7 * outs[0].abs()
                + 1e-4 * scale).all()
    assert (outs[0] - want).abs().max().item() <= K6_TOL * scale


@pytest.mark.gpu
@pytest.mark.parametrize("group", iv.GROUPS)
def test_p4_launches_one_kernel_a_call(cuda, group):
    """One call is one device kernel, P4's bf16_b1_kernel, by
    torch.profiler: no scratch and no second pass."""
    import chip_smoke as cs
    x, w = _p4_inputs(3584, 18944, cuda, 1)
    iv.v6_bf16dot_cuda(x, w, group=group)
    ran = cs._device_kernels(lambda: iv.v6_bf16dot_cuda(x, w, group=group))
    assert sum(ran.values()) == 1, ran
    assert "bf16_b1_kernel" in next(iter(ran)), ran


@pytest.mark.gpu
def test_p4_refuses_what_it_does_not_take(cuda):
    """P4's C entry refuses, before any launch, a depth other than 1, 2 or
    4, a plan that does not cover the rows or exceeds its sizes, a din off
    the 16-row steps, a dout off the 64-column tiles and a misaligned
    operand; the wrapper raises ValueError on such a plan and such
    operands, never falling back."""
    from flash_vstream_tpu_torch.kernels import _build
    lib = _build.library()
    x, w = _p4_inputs(512, 384, cuda, 2)
    out = torch.empty(1, 384, device=cuda, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream(cuda).cuda_stream

    def rc(din=512, dout=384, split=2, warps=4, rows=256, depth=1, dx=0,
           dw=0):
        return lib.fvt_bf16_v6_bf16dot(x.data_ptr() + dx, w.data_ptr() + dw,
                                       out.data_ptr(), din, dout, split,
                                       warps, rows, depth, stream)
    assert rc() == 0
    for bad in (dict(depth=3), dict(depth=8), dict(rows=240),
                dict(split=3, rows=256), dict(warps=0), dict(warps=9),
                dict(split=9, rows=64), dict(dout=352), dict(din=504,
                                                             rows=252),
                dict(dw=2), dict(dx=2)):
        assert rc(**bad) != 0, bad
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="does not take"):
        iv.v6_bf16dot_cuda(x, w, plan=im.Int4Plan(2, 4, 128))
    with pytest.raises(ValueError, match="64-column"):
        iv.v6_bf16dot_cuda(*_p4_inputs(512, 352, cuda, 3), blk=32)
    buf = torch.empty(512 * 384 + 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        iv.v6_bf16dot_cuda(x, buf[1:1 + 512 * 384].view(512, 384))
    with pytest.raises(ValueError, match="group"):
        iv.v6_bf16dot_cuda(x, w, group=6)
