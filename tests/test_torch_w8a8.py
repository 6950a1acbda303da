"""w8a8 prefill (models/layers.py `_w8a8_dot` and the branch in `dense`,
weights/quantize.py `enable_w8a8_prefill`) against the JAX package's, on
the CPU.

Both sides quantize the activations per token the same way (f32 amax and
division, round half to even, clip to [-127, 127]) and take an exact int32
product, so they agree to f32 rounding of the rescale (rtol 1e-6). The
switch is process-wide on both sides; a fixture restores both, since
`--dist loadfile` runs this file's tests in one worker.

The last CPU test reads where chip_smoke.py's limit on w8a8 against
weight-only int8 sits (`-s` prints the readings). The `gpu`-marked test
holds the card's `_w8a8_dot` equal to the CPU's, bit for bit: the same f32
quantization, an exact int32 product and the same f32 rescale. The machine
with the card has no JAX, so JAX loads in fixtures; there the card test
runs alone: python -m pytest --noconftest -m gpu tests/test_torch_w8a8.py
"""
import numpy as np
import pytest
import torch

from flash_vstream_tpu_torch.models import layers as tlayers
from flash_vstream_tpu_torch.weights import quantize as tq
from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy

torch.set_num_threads(1)
W8A8_LIMIT = 3e-2        # chip_smoke.py's, err over max |weight-only out|


@pytest.fixture(scope="module")
def jx():
    """(jnp, the JAX layers module, the JAX quantize module)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from flash_vstream_tpu.models import layers as jlayers
    from flash_vstream_tpu.weights import quantize as jq
    return jnp, jlayers, jq


@pytest.fixture(autouse=True)
def restore_w8a8():
    try:
        from flash_vstream_tpu.models import layers as jlayers
    except ImportError:                  # the card's machine has no JAX
        jlayers = None
    was = tlayers.W8A8_PREFILL, jlayers and jlayers.W8A8_PREFILL
    yield
    tlayers.W8A8_PREFILL = was[0]
    if jlayers is not None:
        jlayers.W8A8_PREFILL = was[1]


def _case(jx, rows, din=256, dout=96, lead=(), seed=0):
    jnp, _, jq = jx
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(din, dout)).astype(np.float32) / np.sqrt(din)
    b = rng.normal(size=(dout,)).astype(np.float32)
    x = (rng.normal(size=(*lead, rows, din)) * 3).astype(np.float32)
    jw = jq.quantize_weight(jnp.asarray(w))
    tw = params_from_numpy({"w": jax_np(jw)}, "cpu")["w"]
    return x, b, jw, tw


def jax_np(tree):
    return type(tree)(*(np.asarray(f) for f in tree))


def test_enable_sets_the_flag():
    tq.enable_w8a8_prefill()
    assert tlayers.W8A8_PREFILL is True
    tq.enable_w8a8_prefill(False)
    assert tlayers.W8A8_PREFILL is False


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_dot_matches_jax(jx, dtype):
    jnp, jlayers, _ = jx
    x, _, jw, tw = _case(jx, 130, seed=1)
    jd = getattr(jnp, dtype)
    want = np.asarray(jlayers._w8a8_dot(jnp.asarray(x, jd), jw.q, jw.scale),
                      np.float32)
    got = tlayers._w8a8_dot(torch.from_numpy(x).to(getattr(torch, dtype)),
                            tw.q, tw.scale)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("rows", [127, 128])
@pytest.mark.parametrize("lead", [(), (2,)])
def test_dense_matches_jax_with_w8a8_on(jx, rows, lead):
    """At 128 rows (x.shape[-2]) both take the int8 x int8 product; at 127
    both stay weight-only, so 127 rows equal weight-only int8 and 128 do
    not."""
    jnp, jlayers, jq = jx
    x, b, jw, tw = _case(jx, rows, lead=lead, seed=rows)
    jq.enable_w8a8_prefill()
    tq.enable_w8a8_prefill()
    want = np.asarray(jlayers.dense(jnp.asarray(x), jw, jnp.asarray(b)))
    got = tlayers.dense(torch.from_numpy(x), tw, torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    tq.enable_w8a8_prefill(False)
    weight_only = tlayers.dense(torch.from_numpy(x), tw, torch.from_numpy(b))
    assert torch.equal(got, weight_only) == (rows < 128)


def test_decode_rows_and_plain_weights_stay_as_they_were(jx):
    """With w8a8 on, a 1-row matvec and a float weight take their usual
    paths."""
    x, _, _, tw = _case(jx, 1, seed=3)
    tq.enable_w8a8_prefill()
    xt = torch.from_numpy(x)
    torch.testing.assert_close(tlayers.dense(xt, tw),
                               torch.matmul(xt, tw.q.float()) * tw.scale)
    w = torch.randn(256, 8)
    big = torch.randn(200, 256)
    torch.testing.assert_close(tlayers.dense(big, w), big @ w)


@pytest.mark.parametrize("rows,din,dout", [
    (256, 1280, 1280), (256, 1280, 5120), (256, 5120, 1280),   # the ViT
    (200, 3584, 512), (200, 3584, 3584), (200, 18944, 256),    # the decoder
])
def test_w8a8_against_weight_only_reads_under_the_card_limit(rows, din, dout):
    """bf16 activations, N(0, 1/din) weights: per-token int8 activations
    move the output by about 1e-2 of its max (read 0.8e-2 to 1.2e-2 here);
    chip_smoke.py holds the card's w8a8 `dense` against weight-only int8
    within W8A8_LIMIT at the ViT's and the decoder's prefill shapes."""
    g = torch.Generator().manual_seed(din + dout)
    x = torch.randn(rows, din, generator=g).to(torch.bfloat16)
    w = tq.quantize_weight(torch.randn(din, dout, generator=g) / din ** 0.5)
    wo = tlayers.dense(x, w).float()
    tq.enable_w8a8_prefill()
    w8 = tlayers.dense(x, w).float()
    err = ((w8 - wo).abs().max() / wo.abs().max()).item()
    print(f"w8a8 vs weight-only [{rows}, {din}] @ [{din}, {dout}]: "
          f"{err:.3e} of max")
    assert 1e-3 < err < W8A8_LIMIT


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rows,din,dout", [
    (17, 64, 64), (317, 64, 64), (317, 64, 32), (130, 128, 64),  # tiny server
    (1024, 1280, 5120), (2989, 3584, 512), (2989, 18944, 3584),  # ViT, 7B
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w8a8_dot_on_card_equals_cpu(cuda, rows, din, dout, dtype):
    g = torch.Generator().manual_seed(rows + din)
    x = (torch.randn(rows, din, generator=g) * 3).to(dtype)
    w = tq.quantize_weight(torch.randn(din, dout, generator=g) / din ** 0.5)
    want = tlayers._w8a8_dot(x, w.q, w.scale)
    got = tlayers._w8a8_dot(x.to(cuda), w.q.to(cuda), w.scale.to(cuda))
    diff = (got.cpu().float() - want.float()).abs()
    assert torch.equal(got.cpu(), want), (diff.max().item(),
                                          int((diff > 0).sum()))


@pytest.mark.gpu
def test_w8a8_on_card_raises_on_shapes_it_does_not_take(cuda):
    w = tq.quantize_weight(torch.randn(64, 60, device=cuda))
    with pytest.raises(ValueError, match="multiples of 8"):
        tlayers._w8a8_dot(torch.randn(200, 64, device=cuda), w.q, w.scale)
    w = tq.quantize_weight(torch.randn(64, 64, device=cuda))
    with pytest.raises(ValueError, match="more than 16 rows"):
        tlayers._w8a8_dot(torch.randn(16, 64, device=cuda), w.q, w.scale)
