"""The port's Qwen2 decoder and greedy Generator against JAX at the tiny
config, in f32 on the CPU: prefill logits (atol 1e-4) with M-RoPE
positions shaped like the streaming prompt and a segment row holding -1
runs, and identical greedy token ids."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_vstream_tpu.core.config import tiny_qwen_config
from flash_vstream_tpu.models import llm as jllm
from flash_vstream_tpu.models.vstream_qwen import init_qwen_params as jax_init
from flash_vstream_tpu.runtime import generation as jgen
from flash_vstream_tpu_torch.models import llm as tllm
from flash_vstream_tpu_torch.models.vstream_qwen import (
    VStreamQwen, init_qwen_params)
from flash_vstream_tpu_torch.runtime import generation as tgen
from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy

torch.set_num_threads(1)
ATOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_qwen_config().llm
    params = jllm.init_llm_params(jax.random.PRNGKey(0), cfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    model = tllm.Qwen2Decoder(cfg, tparams)
    rng = np.random.default_rng(0)
    S = 40
    embeds = rng.normal(size=(1, S, cfg.hidden_size)).astype(np.float32)
    # text 0..5, a visual block with 3D positions, text after max+1
    pos = np.zeros((3, 1, S), np.int32)
    pos[:, 0, :6] = np.arange(6)
    vis = np.stack([np.repeat([0, 3, 7], 8), np.tile(np.repeat(np.arange(2), 4), 3),
                    np.tile(np.arange(4), 6)]) + 6
    pos[:, 0, 6:30] = vis
    st = vis.max() + 1
    pos[:, 0, 30:] = st + np.arange(10)
    seg = np.zeros((1, S), np.int32)
    seg[:, 22:30] = -1                   # padded memory slots
    seg[:, 36:] = -1                     # padded question tail
    last = 35
    return cfg, params, model, embeds, pos, seg, last, int(st) + 6


def test_decoder_forward_no_cache(setup):
    cfg, params, model, embeds, pos, seg, _, _ = setup
    want = jllm.decoder_forward(params, cfg, jnp.asarray(embeds),
                                jnp.asarray(pos), segment_ids=jnp.asarray(seg))[0]
    got = model(torch.from_numpy(embeds), torch.from_numpy(pos),
                segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_prefill_logits(setup):
    cfg, params, model, embeds, pos, seg, last, _ = setup
    jg = jgen.Generator(params, cfg, max_len=128)
    want, _ = jg._prefill(params, jnp.asarray(embeds), jnp.asarray(pos),
                          jg.new_cache(1, 128), jnp.asarray(seg), last)
    tg = tgen.Generator(model, max_len=128)
    cache = tg.new_cache(1, 128)
    got = tg.prefill(torch.from_numpy(embeds), torch.from_numpy(pos), cache,
                     torch.from_numpy(seg), last)
    assert got.shape == (1, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert cache.length == 40
    np.testing.assert_array_equal(cache.segments[:, :40].numpy(), seg)


@pytest.mark.parametrize("eos_at", [None, 3])
def test_greedy_tokens(setup, eos_at):
    cfg, params, model, embeds, pos, seg, last, start = setup
    kw = dict(decode_pos_start=start, last_real_idx=last)
    jg = jgen.Generator(params, cfg, max_len=128)
    tg = tgen.Generator(model, max_len=128)
    want = jg.generate(jnp.asarray(embeds), jnp.asarray(pos),
                       jgen.GenerationConfig(max_new_tokens=10),
                       segment_ids=jnp.asarray(seg), **kw)
    eos = () if eos_at is None else (want[eos_at],)
    if eos:
        want = jg.generate(jnp.asarray(embeds), jnp.asarray(pos),
                           jgen.GenerationConfig(max_new_tokens=10,
                                                 eos_token_ids=eos),
                           segment_ids=jnp.asarray(seg), **kw)
    got = tg.generate(torch.from_numpy(embeds), torch.from_numpy(pos),
                      tgen.GenerationConfig(max_new_tokens=10,
                                            eos_token_ids=eos),
                      segment_ids=torch.from_numpy(seg), **kw)
    assert got == want
    if eos:      # stopped at the first EOS, inclusive
        assert got[-1] == eos[0] and len(got) <= eos_at + 1


def test_embed_and_lm_head(setup):
    cfg, params, model, _, _, _, _, _ = setup
    ids = np.array([[1, 5, 511, 0]])
    np.testing.assert_array_equal(model.embed_tokens(torch.from_numpy(ids)).numpy(),
                                  np.asarray(jllm.embed_tokens(params, jnp.asarray(ids))))
    h = np.random.default_rng(1).normal(size=(2, cfg.hidden_size)).astype(np.float32)
    np.testing.assert_allclose(model.logits(torch.from_numpy(h)).numpy(),
                               np.asarray(jllm.lm_head(params, cfg, jnp.asarray(h))),
                               atol=ATOL)


def test_init_matches_jax_tree():
    """Same key paths, shapes and dtypes as the JAX init; norms and biases
    are ones/zeros; random leaves have the JAX init's scale."""
    cfg = tiny_qwen_config()
    want = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), cfg))
    got = init_qwen_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(want)
    tleaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), got))
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (path, a), (_, b) in zip(jleaves, tleaves):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if np.all(a == a.flat[0]):           # ones / zeros
            np.testing.assert_array_equal(b, a, err_msg=str(path))
        elif a.size >= 1000:
            assert abs(b.std() / a.std() - 1) < 0.1, path
    model = VStreamQwen(cfg, got)
    keys = {".".join(str(k.key) for k in p) for p, _ in tleaves}
    assert set(model.state_dict()) == keys


def test_params_from_numpy_dtype_and_quantized_leaves():
    from flash_vstream_tpu.weights.quantize import quantize_weight
    tree = {"a": {"w": np.ones((4, 8), np.float32)},
            "ids": np.arange(3, dtype=np.int32)}
    got = params_from_numpy(tree, "cpu", torch.bfloat16)
    assert got["a"]["w"].dtype == torch.bfloat16
    assert got["ids"].dtype == torch.int32           # only floats are cast
    quant = {"w": quantize_weight(jnp.ones((8, 4)))}
    got = params_from_numpy(jax.tree.map(np.asarray, quant), "cpu",
                            torch.bfloat16)["w"]
    assert type(got).__name__ == "QuantWeight"
    assert got.q.dtype == torch.int8                 # values stay int8
    assert got.scale.dtype == torch.float32          # scales stay f32
    with pytest.raises(NotImplementedError, match="not an array"):
        params_from_numpy({"w": object()}, "cpu")


@pytest.mark.parametrize("t,h,w", [(1, 16, 16), (7, 16, 16), (90, 16, 16),
                                   (40, 32, 24)])
def test_visual_token_count(t, h, w):
    from flash_vstream_tpu.models.vstream_qwen import (
        visual_token_count as jax_count)
    from flash_vstream_tpu_torch.models.vstream_qwen import visual_token_count
    from flash_vstream_tpu.core.config import VStreamQwenConfig
    cfg = VStreamQwenConfig()
    assert visual_token_count(cfg, t, h, w) == jax_count(cfg, t, h, w)
