"""models/layers.py of the port against the JAX layers, in f32 on the CPU
(atol 1e-5: the same f32 arithmetic, summed in a different order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_vstream_tpu.models import layers as jl
from flash_vstream_tpu_torch.models import layers as tl
from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy

torch.set_num_threads(1)
ATOL = 1e-5


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture
def x():
    return np.random.default_rng(0).normal(size=(2, 7, 64)).astype(np.float32)


def test_rms_norm(x):
    s = np.random.default_rng(1).normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(tl.rms_norm(_t(x), _t(s), 1e-6).numpy(),
                               _np(jl.rms_norm(jnp.asarray(x), s, 1e-6)),
                               atol=ATOL)


def test_layer_norm_population_variance(x):
    rng = np.random.default_rng(2)
    s, b = rng.normal(size=(2, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tl.layer_norm(_t(x), _t(s), _t(b), 1e-6).numpy(),
        _np(jl.layer_norm(jnp.asarray(x), s, b, 1e-6)), atol=ATOL)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu", "silu"])
def test_activations(x, act):
    np.testing.assert_allclose(tl.ACTIVATIONS[act](_t(x)).numpy(),
                               _np(jl.ACTIVATIONS[act](jnp.asarray(x))),
                               atol=ATOL)


def test_dense_with_bias(x):
    rng = np.random.default_rng(3)
    w = rng.normal(size=(64, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    np.testing.assert_allclose(tl.dense(_t(x), _t(w), _t(b)).numpy(),
                               _np(jl.dense(jnp.asarray(x), w, b)), atol=1e-4)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_angles(theta):
    pos = np.arange(0, 3000, 7, dtype=np.int32)[None]
    for a, b in zip(tl.rope_angles(_t(pos), 128, theta),
                    jl.rope_angles(jnp.asarray(pos), 128, theta)):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=ATOL)


def test_mrope_angles():
    rng = np.random.default_rng(4)
    pos = rng.integers(0, 300, size=(3, 2, 9)).astype(np.int32)
    for a, b in zip(tl.mrope_angles(_t(pos), 16, (2, 3, 3), 1e6),
                    jl.mrope_angles(jnp.asarray(pos), 16, (2, 3, 3), 1e6)):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=ATOL)


def test_vision_rope_angles():
    from flash_vstream_tpu_torch.models.qwen2_vit import grid_positions
    pos = grid_positions([(1, 16, 16)])
    for a, b in zip(tl.vision_rope_angles(_t(pos[:, 0]), _t(pos[:, 1]), 80),
                    jl.vision_rope_angles(jnp.asarray(pos[:, 0]),
                                          jnp.asarray(pos[:, 1]), 80)):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=ATOL)


def test_apply_rope():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 4, 9, 16)).astype(np.float32)
    pos = rng.integers(0, 50, size=(3, 2, 9)).astype(np.int32)
    cos, sin = jl.mrope_angles(jnp.asarray(pos), 16, (2, 3, 3), 1e6)
    want = jl.apply_rope(jnp.asarray(q), cos, sin)
    got = tl.apply_rope(_t(q), _t(cos), _t(sin))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


def _attn_params(seed, D=64, Hq=4, Hkv=2, Dh=16):
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    p = {"wq": jl.init_dense(ks[0], D, Hq * Dh, bias=True),
         "wk": jl.init_dense(ks[1], D, Hkv * Dh, bias=True),
         "wv": jl.init_dense(ks[2], D, Hkv * Dh, bias=True),
         "wo": jl.init_dense(ks[3], Hq * Dh, D)}
    return p, params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def test_mha_prefill_then_decode_against_cache():
    """A segmented causal prefill into the cache, then one decode step that
    reads the cache prefix (padded slots -1 are never attended)."""
    B, S, D, Hq, Hkv, Dh, Smax = 1, 12, 64, 4, 2, 16, 16
    jp, tp = _attn_params(0)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    x1 = rng.normal(size=(B, 1, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S + 1, dtype=np.int32), (3, B, S + 1))
    seg = np.zeros((B, S), np.int32)
    seg[:, 4:7] = -1
    seg[:, -2:] = -1
    cos, sin = jl.mrope_angles(jnp.asarray(pos), Dh, (2, 3, 3), 1e6)
    kw = dict(num_heads=Hq, num_kv_heads=Hkv, head_dim=Dh)

    # prefill
    kc = jnp.zeros((B, Hkv, Smax, Dh))
    want, (kc, vc) = jl.mha(jp, jnp.asarray(x), **kw,
                            rope=(cos[:, :S], sin[:, :S]), causal=True,
                            q_segment_ids=jnp.asarray(seg),
                            kv_segment_ids=jnp.asarray(seg),
                            kv_cache=(kc, kc), cache_len=jnp.int32(0))
    tkc, tvc = torch.zeros(B, Hkv, Smax, Dh), torch.zeros(B, Hkv, Smax, Dh)
    tcos, tsin = _t(cos), _t(sin)
    got = tl.mha(tp, _t(x), **kw, rope=(tcos[:, :S], tsin[:, :S]),
                 causal=True, q_segment_ids=_t(seg), kv_segment_ids=_t(seg),
                 kv_cache=(tkc, tvc), cache_len=0)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)
    np.testing.assert_allclose(tkc.numpy(), _np(kc), atol=ATOL)
    np.testing.assert_allclose(tvc.numpy(), _np(vc), atol=ATOL)

    # decode step at position S
    segs = np.full((B, Smax), -1, np.int32)
    segs[:, :S] = seg
    segs[:, S] = 0
    want, _ = jl.mha(jp, jnp.asarray(x1), **kw,
                     rope=(cos[:, S:], sin[:, S:]), kv_cache=(kc, vc),
                     cache_len=jnp.int32(S), cache_segments=jnp.asarray(segs))
    got = tl.mha(tp, _t(x1), **kw, rope=(tcos[:, S:], tsin[:, S:]),
                 kv_cache=(tkc, tvc), cache_len=S, cache_segments=_t(segs))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


def test_mha_no_cache_segments(x):
    jp, tp = _attn_params(1)
    seg = np.zeros((2, 7), np.int32)
    seg[:, 3:] = 1
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=16)
    want, _ = jl.mha(jp, jnp.asarray(x), **kw, q_segment_ids=jnp.asarray(seg),
                     kv_segment_ids=jnp.asarray(seg))
    got = tl.mha(tp, _t(x), **kw, q_segment_ids=_t(seg),
                 kv_segment_ids=_t(seg))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


def test_swiglu_mlp(x):
    ks = jax.random.split(jax.random.PRNGKey(2), 3)
    p = {"gate": jl.init_dense(ks[0], 64, 128), "up": jl.init_dense(ks[1], 64, 128),
         "down": jl.init_dense(ks[2], 128, 64)}
    want = jl.swiglu_mlp(p, jnp.asarray(x))
    got = tl.swiglu_mlp(params_from_numpy(jax.tree.map(np.asarray, p), "cpu"), _t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_gelu_mlp(x, act):
    ks = jax.random.split(jax.random.PRNGKey(3), 2)
    p = {"fc1": jl.init_dense(ks[0], 64, 128, bias=True),
         "fc2": jl.init_dense(ks[1], 128, 64, bias=True)}
    want = jl.gelu_mlp(p, jnp.asarray(x), act)
    got = tl.gelu_mlp(params_from_numpy(jax.tree.map(np.asarray, p), "cpu"), _t(x),
                      act)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


def test_quantized_leaves_and_int8_cache_raise():
    """Quantized leaves are ported (tests/test_torch_quantize.py holds them
    against JAX); a leaf of no known kind raises, and so does the int8 KV
    cache, which is not ported yet."""
    from flash_vstream_tpu_torch.weights.quantize import quantize_weight4
    qw = quantize_weight4(torch.ones(4, 8))
    assert tl.dense(torch.ones(2, 4), qw).shape == (2, 8)
    with pytest.raises(TypeError, match="QuantWeight4"):
        tl.dense(torch.zeros(2, 4), object())
    with pytest.raises(NotImplementedError, match="A10"):
        tl.KVCache.create(1, 1, 1, 8, 4, dtype=torch.int8)
