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


# --- v2 and v5 on K6's B = 1 kernel: conversions, schedule, load depth ----

# the two conversions of csrc/int4_b1.cuh: (A fragment mirror, what the
# fragment holds for a nibble n, the fold's bias constant)
CONVERSIONS = {"PerElement": (iv.per_element_fragment, 0, 8.0),
               "Packed": (im.fragment_map, 128, 136.0)}


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


@pytest.mark.parametrize("seed", [0, 1])
def test_per_element_fragments_pair_every_nibble_with_its_own_x(seed):
    """One warp step of v2's conversion, on bytes 0-255: the A fragments of
    every lane and tile put into the m16n8k16 matrix by the PTX fragment
    layout, times B from x at each lane's k rows; lane (g, 0)'s c0 and c3
    equal, exactly, column 16g + j's sums of n x over the step's 16 rows
    for the low and the high nibbles (Packed's fragments, 128 + n, are
    held the same way in test_torch_int4_matmul.py)."""
    frag, offset, _ = CONVERSIONS["PerElement"]
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 256, (16, 128), dtype=np.uint8)
    w[0, :16] = np.arange(0, 256, 16)      # every high nibble, every low 0
    w[1, :16] = np.arange(16)               # every low nibble
    xs = rng.integers(-1000, 1000, (2, 16)).astype(np.float64)
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


def _emulate_b1(x, q4, scale, plan, offset, bias):
    """csrc/int4_b1.cuh `int4_fold_kernel` step by step in numpy (f32), for
    a conversion whose fragments hold offset + n and whose fold takes bias
    sum x off: each warp's steps in order, a step's two passes where it
    spans two scale blocks, the fold at each block change with the quad's
    x sums, then the warps summed in warp order and the ranks in rank
    order. The products are taken exactly (f64, then rounded once a
    step)."""
    dh, dout = q4.shape
    nbh = scale.shape[0] // 2
    bs = dh // nbh
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
    of 128 packed rows (the probe's nb = din / 128), equals v2's plain
    version in f32 within 1e-5 of the output's max: no row is missed or
    counted twice, each block's bias and scales are its own, also where a
    warp starts mid-block."""
    _, offset, bias = CONVERSIONS[conv]
    x, q, s = _inputs(din, dout, seed=din + dout)
    plan = im._plan(1, din // 2, din // 128, dout, sms)
    got = _emulate_b1(x, q, s, plan, offset, bias)
    want = iv.v2_biasfold_reference(torch.from_numpy(x), torch.from_numpy(q),
                                    torch.from_numpy(s),
                                    torch.float32).numpy()[0]
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


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


# --- v2 and v5 on the card: one launch, the same bits, the plans ---------

FOLD = {"v2-biasfold": iv.v2_biasfold_cuda, "v5-u8mask": iv.v5_u8mask_cuda}


@pytest.mark.gpu
@pytest.mark.parametrize("din,dout", [(3584, 18944), (512, 384)])
@pytest.mark.parametrize("name", sorted(FOLD))
def test_fold_variants_same_bits_across_runs_and_plans(cuda, name, din,
                                                       dout):
    """v2 and v5 give the same bits from run to run at K6's plan and at
    others (one cluster, 8 warps; two ranks of 4 warps); v5 gives K6's own
    bits at each plan (one template, one conversion); across plans the
    f32 sums differ only in order, so the bf16 outputs agree within one
    bf16 step of the output (2^-7 of it) plus 1e-4 of its max."""
    x, q, s = _card_inputs(din, dout, cuda, din)
    dh = din // 2
    kernel = FOLD[name]
    want = iv.v2_biasfold_reference(x, q, s, torch.float32)
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
    """The C entries of v2 and v5 refuse, before any launch, a depth other
    than 1, 2 or 4, a plan that does not cover the rows or exceeds its
    sizes, and a dout off the 128-column tiles; the wrappers refuse such a
    dout with a ValueError."""
    from flash_vstream_tpu_torch.kernels import _build
    lib = _build.library()
    x, q, s = _card_inputs(512, 384, cuda, 2)
    out = torch.empty(1, 384, device=cuda, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for fn in (lib.fvt_int4_v2_biasfold, lib.fvt_int4_v5_u8mask):
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
