"""The ViT probe's block variants (flash_vstream_tpu_torch/scripts/
probe_vit_variants.py) against the JAX `qwen_vit_blocks_frames` on the same
params and patches: the tiny 2-layer Qwen2-VL ViT (hidden 32, 4 heads) in
f32 on the CPU, one clip of 16 frames at 112 px (8 temporal pairs: 512
full-stream and 128 small-stream tokens, so every projection has >= 128
rows and takes w8a8 when it is on, in every mode).

Tolerance: atol 1e-4, as tests/test_torch_vit.py (layers of f32 matmuls
summed in another order). Under w8a8 the activations are rounded to int8
per token on both sides, and an activation that lands within f32 noise of
a rounding step may round the other way in one package: one such flip in
the first layer moves the rows of its frame by up to 2.3e-2 here (57 of
640 rows past 1e-4, 0.5% of the output's max). So with w8a8 each mode is
held to the port's own base at 1e-4 (the modes regroup the same
per-token products), and the port to JAX with at least 3/4 of the rows
within 1e-4 and every element within W8A8_ATOL.

`onecall` is held to its definition rather than to base: the JAX probe
pads the small stream's frames with zero keys and calls attention without
a mask, which equals base attention with P_full - P_small zero keys
appended to each small frame. It equals base on the full stream and not on
the small one. `noattn` equals the JAX encode with attention replaced by v.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_vstream_tpu.core.config import tiny_qwen_config as jax_tiny
from flash_vstream_tpu.kernels import flash_attention as jfa
from flash_vstream_tpu.models import layers as jlayers
from flash_vstream_tpu.models import qwen2_vit as jv
from flash_vstream_tpu.weights import quantize as jq
from flash_vstream_tpu_torch.core.config import tiny_qwen_config
from flash_vstream_tpu_torch.models import layers as tlayers
from flash_vstream_tpu_torch.scripts import probe_vit_variants as probe
from flash_vstream_tpu_torch.weights import quantize as tq
from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy

torch.set_num_threads(1)
ATOL = 1e-4
W8A8_ATOL = 1e-1      # 2% of the output's max, 4.3x the one flip read
GEO = probe.Geometry.of(side=112, clip=16)
KW = dict(t_full=GEO.t, hw_full=(GEO.g, GEO.g), t_small=GEO.t,
          hw_small=(GEO.g // 2, GEO.g // 2))
COMPARED = ("base", "fusedqkv", "combqkv", "xlaattn", "framekernel")


@pytest.fixture(autouse=True)
def restore_w8a8():
    was = (jlayers.W8A8_PREFILL, tlayers.W8A8_PREFILL)
    yield
    jlayers.W8A8_PREFILL, tlayers.W8A8_PREFILL = was


@pytest.fixture(scope="module")
def case():
    """(JAX cfg, port cfg, JAX params, patches [St, pd] f32)."""
    jcfg, tcfg = jax_tiny().vit, tiny_qwen_config().vit
    jparams = jv.init_qwen_vit_params(jax.random.PRNGKey(0), jcfg)
    pd = jcfg.in_channels * jcfg.temporal_patch_size * jcfg.patch_size ** 2
    patches = np.random.default_rng(0).normal(size=(GEO.St, pd))
    return jcfg, tcfg, jparams, patches.astype(np.float32)


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _encode(mode, tcfg, tparams, patches):
    return probe.encode(mode, tparams, tcfg, GEO,
                        torch.from_numpy(patches)).numpy()


def test_geometry_and_flops():
    assert (GEO.t, GEO.g, GEO.P_full, GEO.P_small) == (8, 8, 64, 16)
    assert (GEO.S, GEO.S_small, GEO.St) == (512, 128, 640)
    full = probe.Geometry.of(224, 8)
    assert (full.S, full.S_small) == (1024, 256)
    # the JAX probe's formula at the full ViT, 224 px, clip 8
    cfg = probe.QWEN2_VL_VIT
    assert probe.vit_flops(cfg, full) == 32 * (
        8 * 1280 * 1280 * 1280 + 4 * 1280 * 1280 * 5120
        + 4 * 4 * 16 * 80 * (256 ** 2 + 64 ** 2))


@pytest.mark.parametrize("quant", ["bf16", "int8_weight_only", "int8"])
@pytest.mark.parametrize("mode", COMPARED)
def test_mode_matches_jax_vit(case, mode, quant):
    """Each mode's encode against the JAX encode: f32 weights, int8
    weight-only (`--int8-weight-only`, the JAX int8 tree), and int8 with
    w8a8 on both sides (`--int8`). "bf16" names the probe's default run;
    here the weights are f32."""
    jcfg, tcfg, jparams, patches = case
    if quant != "bf16":
        jparams = jq.quantize_params(jparams)
    tparams = _port(jparams)
    if quant == "int8":
        jq.enable_w8a8_prefill()
        tq.enable_w8a8_prefill()
    want = np.asarray(jv.qwen_vit_blocks_frames(
        jparams, jcfg, jnp.asarray(patches), **KW))
    got = _encode(mode, tcfg, tparams, patches)
    assert got.shape == (GEO.St, tcfg.hidden_size)
    if quant != "int8":
        np.testing.assert_allclose(got, want, atol=ATOL)
        return
    np.testing.assert_allclose(
        got, _encode("base", tcfg, tparams, patches), atol=ATOL)
    err = np.abs(got - want)
    assert (err.max(axis=1) <= ATOL).mean() >= 0.75
    assert err.max() <= W8A8_ATOL


def test_fused_int8_projection_is_one_quant_weight(case):
    """fusedqkv concatenates the int8 columns and per-channel scales, so
    one activation quantization feeds q, k and v under w8a8."""
    _, _, jparams, _ = case
    lp = tlayers.layer_slice(_port(jq.quantize_params(jparams))["layers"], 0)
    x = torch.randn(130, 32, generator=torch.Generator().manual_seed(0))
    tq.enable_w8a8_prefill()
    q, k, v = probe.qkv_fused(lp, x)
    for got, n in zip((q, k, v), ("wq", "wk", "wv")):
        w = lp["attn"][n]
        torch.testing.assert_close(got, tlayers.dense(x, w["w"], w.get("b")),
                                   rtol=1e-6, atol=1e-6)


def _patched_jax_encode(monkeypatch, jcfg, jparams, patches, attn):
    monkeypatch.setattr(jfa, "flash_attention", attn)
    return np.asarray(jv.qwen_vit_blocks_frames(
        jparams, jcfg, jnp.asarray(patches), **KW))


def test_onecall_is_base_with_zero_keys_on_the_small_stream(case, monkeypatch):
    jcfg, tcfg, jparams, patches = case
    got = _encode("onecall", tcfg, _port(jparams), patches)
    base = np.asarray(jv.qwen_vit_blocks_frames(
        jparams, jcfg, jnp.asarray(patches), **KW))
    pad = GEO.P_full - GEO.P_small

    def padded(q, k, v):       # zero keys and values after a small frame's
        if q.shape[2] == GEO.P_small:
            z = ((0, 0), (0, 0), (0, pad), (0, 0))
            k, v = jnp.pad(k, z), jnp.pad(v, z)
        return jfa.xla_attention(q, k, v)
    want = _patched_jax_encode(monkeypatch, jcfg, jparams, patches, padded)
    np.testing.assert_allclose(got, want, atol=ATOL)
    S = GEO.S
    np.testing.assert_allclose(got[:S], base[:S], atol=ATOL)
    assert np.abs(got[S:] - base[S:]).max() > 100 * ATOL


def test_noattn_is_the_encode_with_attention_replaced_by_v(case, monkeypatch):
    jcfg, tcfg, jparams, patches = case
    got = _encode("noattn", tcfg, _port(jparams), patches)
    want = _patched_jax_encode(monkeypatch, jcfg, jparams, patches,
                               lambda q, k, v: v)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_single_layer_loop_and_main_on_cpu(capsys):
    """The probe's entry point on the CPU at a tiny size: every mode prints
    its line and the JSON line grows by one mode each time; the error
    against base is 0 for base itself."""
    modes = ",".join(probe.MODES)
    res = probe.main(["--device", "cpu", "--side", "56", "--clip", "4",
                      "--layers", "1", "--iters", "1", "--trials", "1",
                      "--modes", modes])
    assert list(res) == list(probe.MODES)
    assert res["base"]["err"] == 0.0
    assert all(r["s"] > 0 and r["eager_s"] > 0 for r in res.values())
    out = capsys.readouterr()
    last = out.out.strip().splitlines()[-1]
    assert list(json.loads(last)) == list(probe.MODES)
    assert len([ln for ln in out.err.splitlines() if "ms/clip" in ln]) == 7
    res = probe.main(["--device", "cpu", "--side", "56", "--clip", "4",
                      "--layers", "1", "--iters", "2", "--trials", "1",
                      "--modes", "framekernel", "--single-layer", "--int8"])
    assert res["framekernel"]["blocks"] >= 2
    assert tlayers.W8A8_PREFILL is False          # restored after the run


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown mode"):
        probe.make_blocks("nope", tiny_qwen_config().vit, GEO,
                          torch.device("cpu"))
