"""The port's weight quantization (weights/quantize.py), quantized `dense`,
embeddings, parameter trees and an int4 decoder, held against the JAX
package on the CPU.

Quantization must produce the JAX package's bytes exactly (both round half
to even and divide in f32), so int8 / int4 values and f32 scales are
compared bit for bit. Quantized matmuls on the CPU take the JAX package's
own dequantize-then-matmul path in both, so f32 results agree to f32
summation order (rtol 1e-5); the int4 decoder's logits to atol 1e-4, as
the bf16/f32 decoder's in test_torch_llm.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_vstream_tpu.core.config import LLMConfig as JaxLLMConfig
from flash_vstream_tpu.core.config import tiny_qwen_config as jax_tiny
from flash_vstream_tpu.models import layers as jlayers
from flash_vstream_tpu.models import llm as jllm
from flash_vstream_tpu.models.vstream_qwen import init_qwen_params as jax_init
from flash_vstream_tpu.runtime import generation as jgen
from flash_vstream_tpu.weights import quantize as jq
from flash_vstream_tpu_torch.core.config import LLMConfig
from flash_vstream_tpu_torch.models import layers as tlayers
from flash_vstream_tpu_torch.models import llm as tllm
from flash_vstream_tpu_torch.runtime import generation as tgen
from flash_vstream_tpu_torch.weights import quantize as tq
from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy

torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _fields_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, str(w.dtype)), (g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("shape,block", [
    ((64, 48), 128),          # one block (nb 1)
    ((512, 384), 128),        # nb 4
    ((2, 130, 20), 128),      # stacked; 130 = 2 x 65: odd block size 2
    ((3, 896, 128), 32),      # stacked, nb 28
    ((256, 40), 48),          # block 48 -> largest even divisor 32
])
def test_quantize_weight4_bytes_equal_jax(shape, block):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    _fields_equal(tq.quantize_weight4(torch.from_numpy(w), block=block),
                  jq.quantize_weight4(jnp.asarray(w), block=block))


@pytest.mark.parametrize("shape", [(32, 16), (3, 64, 48)])
def test_quantize_weight_int8_bytes_equal_jax(shape):
    w = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    _fields_equal(tq.quantize_weight(torch.from_numpy(w)),
                  jq.quantize_weight(jnp.asarray(w)))


def test_quantize_bf16_weights_equal_jax():
    w = np.random.default_rng(2).normal(size=(2, 256, 128)).astype(np.float32)
    got = tq.quantize_weight4(torch.from_numpy(w).to(torch.bfloat16))
    _fields_equal(got, jq.quantize_weight4(jnp.asarray(w, jnp.bfloat16)))


@pytest.mark.parametrize("din,block", [(512, 128), (130, 128), (6, 4),
                                       (1000, 128), (2, 128)])
def test_block_size4_equals_jax(din, block):
    assert tq._block_size4(din, block) == jq._block_size4(din, block)


def test_unpack_and_dequantize_equal_jax():
    w = np.random.default_rng(3).normal(size=(2, 512, 64)).astype(np.float32)
    jw = jq.quantize_weight4(jnp.asarray(w))
    tw = tq.QuantWeight4(torch.from_numpy(np.array(jw.q4)),
                         torch.from_numpy(np.array(jw.scale)))
    np.testing.assert_array_equal(tq.unpack_weight4(tw).numpy(),
                                  np.asarray(jq.unpack_weight4(jw)))
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            tq.dequantize_weight4(tw, tdt).float().numpy(),
            np.asarray(jq.dequantize_weight4(jw, jdt), np.float32))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_targets_and_bytes_equal_jax(bits):
    """The default targets pick the same leaves of the tiny Qwen tree (the
    decoder's seven projections and lm_head; the ViT blocks but not the
    patch embedding or the merger), with the same bytes; the rest pass
    through untouched."""
    params = jax_init(jax.random.PRNGKey(0), jax_tiny())
    tparams = params_from_numpy(_np(params), "cpu")
    if bits == 4:
        want = {"llm": jq.quantize_params4(params["llm"])}
        got = {"llm": tq.quantize_params4(tparams["llm"])}
    else:
        want = {k: jq.quantize_params(params[k]) for k in ("llm", "vit")}
        got = {k: tq.quantize_params(tparams[k]) for k in ("llm", "vit")}
    want_leaves = jax.tree_util.tree_leaves_with_path(
        want, is_leaf=lambda x: isinstance(x, (jq.QuantWeight,
                                               jq.QuantWeight4)))
    n_quant = 0
    for path, w in want_leaves:
        g = got
        for p in path:
            g = g[p.key]
        if isinstance(w, (jq.QuantWeight, jq.QuantWeight4)):
            _fields_equal(g, w)
            n_quant += 1
        else:
            assert isinstance(g, torch.Tensor)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert n_quant == (8 if bits == 4 else 8 + 6)


def test_params_from_numpy_carries_quantized_leaves():
    """JAX QuantWeight/QuantWeight4 leaves become the port's types with
    their dtypes kept (scales f32 even when floats are cast to bf16)."""
    w = np.random.default_rng(4).normal(size=(64, 32)).astype(np.float32)
    tree = {"a": {"w": jq.quantize_weight4(jnp.asarray(w))},
            "b": jq.quantize_weight(jnp.asarray(w)),
            "n": np.ones(4, np.float32)}
    got = params_from_numpy(_np(tree), "cpu", torch.bfloat16)
    assert isinstance(got["a"]["w"], tq.QuantWeight4)
    assert isinstance(got["b"], tq.QuantWeight)
    assert got["a"]["w"].q4.dtype == torch.uint8
    assert got["a"]["w"].scale.dtype == torch.float32
    assert got["b"].q.dtype == torch.int8
    assert got["b"].scale.dtype == torch.float32
    assert got["n"].dtype == torch.bfloat16
    _fields_equal(got["a"]["w"], tree["a"]["w"])


@pytest.mark.parametrize("rows", [1, 8, 64])
@pytest.mark.parametrize("bits", [8, 4])
def test_dense_matches_jax(rows, bits):
    """Quantized `dense` on the CPU against JAX `dense`, f32 activations,
    with a bias; nb 4 so the int4 weight would pass the K6 gate at 1 and 8
    rows on the card (here both take the dequantize path)."""
    rng = np.random.default_rng(rows)
    w = rng.normal(size=(512, 256)).astype(np.float32)
    b = rng.normal(size=(256,)).astype(np.float32)
    x = rng.normal(size=(1, rows, 512)).astype(np.float32)
    jw = (jq.quantize_weight4 if bits == 4 else jq.quantize_weight)(
        jnp.asarray(w))
    tw = params_from_numpy({"w": _np(jw)}, "cpu")["w"]
    want = np.asarray(jlayers.dense(jnp.asarray(x), jw, jnp.asarray(b)))
    got = tlayers.dense(torch.from_numpy(x), tw, torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_embed_tokens_match_jax(bits):
    w = np.random.default_rng(5).normal(size=(64, 16)).astype(np.float32)
    jw = (jq.quantize_weight4(jnp.asarray(w), block=16) if bits == 4
          else jq.quantize_weight(jnp.asarray(w)))
    tw = params_from_numpy({"embed": _np(jw)}, "cpu")
    ids = np.random.default_rng(6).integers(0, 64, (2, 9))
    want = np.asarray(jllm.embed_tokens({"embed": jw}, jnp.asarray(ids)),
                      np.float32)
    got = tllm.embed_tokens(tw, torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_param_tree_holds_quantized_leaves():
    """A quantized leaf sits in the module as its fields under the leaf's
    key path, frozen; `tree()` gives back the NamedTuple; a module-wide
    bf16 cast keeps uint8 values and f32 scales; `layer_slice` slices both
    fields."""
    w = torch.randn(3, 256, 64, generator=torch.Generator().manual_seed(0))
    qw = tq.quantize_weight4(w)
    tree = {"attn": {"wq": {"w": qw}}, "norm": torch.ones(3, 8)}
    mod = tlayers.ParamTree(tree).to(torch.bfloat16)
    assert set(mod.state_dict()) == {"attn.wq.w.q4", "attn.wq.w.scale",
                                     "norm"}
    got = mod.tree()["attn"]["wq"]["w"]
    assert isinstance(got, tq.QuantWeight4)
    assert got.q4.dtype == torch.uint8 and got.scale.dtype == torch.float32
    assert not any(p.requires_grad for p in mod.parameters())
    assert mod.tree()["norm"].dtype == torch.bfloat16
    assert torch.equal(got.scale, qw.scale)
    one = tlayers.layer_slice(mod.tree(), 1)["attn"]["wq"]["w"]
    assert isinstance(one, tq.QuantWeight4)
    assert torch.equal(one.q4, qw.q4[1]) and torch.equal(one.scale,
                                                         qw.scale[1])


# widths at which the decoder's int4 projections would open the K6 gate on
# the card (nb even, dout a multiple of 128), as in chip_smoke's reference
GATE_CFG = dict(vocab_size=1024, hidden_size=256, intermediate_size=512,
                num_layers=2, num_heads=2, num_kv_heads=1,
                attention_bias=True, mrope_sections=(16, 24, 24))


@pytest.fixture(scope="module")
def int4_decoder():
    jcfg = JaxLLMConfig(**GATE_CFG)
    tcfg = LLMConfig(**GATE_CFG)
    params = jllm.init_llm_params(jax.random.PRNGKey(0), jcfg)
    qp = jq.quantize_params4(params)
    assert isinstance(qp["lm_head"], jq.QuantWeight4)
    model = tllm.Qwen2Decoder(tcfg, params_from_numpy(_np(qp), "cpu"))
    rng = np.random.default_rng(0)
    S = 24
    embeds = rng.normal(size=(1, S, 256)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, 1, S)).copy()
    seg = np.zeros((1, S), np.int32)
    seg[:, 20:] = -1
    return jcfg, qp, model, embeds, pos, seg


def test_int4_decoder_prefill_matches_jax(int4_decoder):
    jcfg, qp, model, embeds, pos, seg = int4_decoder
    jg = jgen.Generator(qp, jcfg, max_len=64)
    want, _ = jg._prefill(qp, jnp.asarray(embeds), jnp.asarray(pos),
                          jg.new_cache(1, 64), jnp.asarray(seg), 19)
    tg = tgen.Generator(model, max_len=64)
    got = tg.prefill(torch.from_numpy(embeds), torch.from_numpy(pos),
                     tg.new_cache(1, 64), torch.from_numpy(seg), 19)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_int4_decoder_decode_tokens_match_jax(int4_decoder):
    jcfg, qp, model, embeds, pos, seg = int4_decoder
    kw = dict(decode_pos_start=20, last_real_idx=19)
    want = jgen.Generator(qp, jcfg, max_len=64).generate(
        jnp.asarray(embeds), jnp.asarray(pos),
        jgen.GenerationConfig(max_new_tokens=8),
        segment_ids=jnp.asarray(seg), **kw)
    got = tgen.Generator(model, max_len=64).generate(
        torch.from_numpy(embeds), torch.from_numpy(pos),
        tgen.GenerationConfig(max_new_tokens=8),
        segment_ids=torch.from_numpy(seg), **kw)
    assert len(got) == 8 and got == want


def test_quantized_head_chunked_loss_still_raises(int4_decoder):
    """The vocab-tiled loss of quantized heads is training (QLoRA)."""
    _, _, model, _, _, _ = int4_decoder
    h = torch.zeros(1, 4, 256)
    with pytest.raises(NotImplementedError, match="A12"):
        tllm.cross_entropy_loss_chunked(model.tree(), model.cfg, h,
                                        torch.zeros(1, 4, dtype=torch.long))
