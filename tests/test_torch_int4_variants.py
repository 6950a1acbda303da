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
