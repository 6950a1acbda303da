"""The int8 KV cache of the port (models/layers.py, models/llm.py,
runtime/generation.py) against the JAX package's, in f32 on the CPU:
`quantize_kv` (int8 values equal, scales within 1e-6 relative),
`cache_attention`'s int8 branch (1e-5), the decode_multi forward over an
int8 cache (ATOL of tests/test_torch_generation.py), and every Generator
path over an int8 cache (greedy, stepwise, sampled from JAX's draws,
preemptible decode chunks, prefill chunks, prompt-lookup speculation,
left-padded batches): token ids exact, as the JAX tests hold the int8
cache (tests/test_generation.py:75-86, 151-155, 205-215). The int8 cache
agrees with the f32 cache in at least n - 1 of n greedy tokens."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_vstream_tpu.core.config import LLMConfig as JaxLLMConfig
from flash_vstream_tpu.models import layers as jl
from flash_vstream_tpu.models import llm as jllm
from flash_vstream_tpu.runtime import generation as jgen
from flash_vstream_tpu_torch.core.config import LLMConfig
from flash_vstream_tpu_torch.models import layers as tl
from flash_vstream_tpu_torch.models import llm as tllm
from flash_vstream_tpu_torch.runtime import generation as tgen
from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy
from test_torch_generation import KW, REAL, S, both, jax_gumbel

torch.set_num_threads(1)
ATOL = 1e-4


def test_quantize_kv_matches_jax():
    """Values spread over several decades, one all-zero row (the 1e-12
    scale floor) and exact halves of a step (round half to even)."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 3, 7, 16))
         * 10.0 ** rng.integers(-3, 3, (2, 3, 7, 1))).astype(np.float32)
    x[0, 1, 2] = 0.0
    x[1, 0, 0] = np.arange(16, dtype=np.float32) - 7.5   # scale 1: halves
    x[1, 0, 0, 0] = 127.0
    wq, ws = jl.quantize_kv(jnp.asarray(x))
    q, s = tl.quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == (2, 3, 7, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-6)
    assert s[0, 1, 2, 0] == np.float32(1e-12) and not q[0, 1, 2].any()


@pytest.mark.parametrize("q_offset,sq", [(6, 1), (4, 3), (0, 5)])
def test_cache_attention_int8_matches_jax(q_offset, sq):
    """GQA (4 query heads over 2), keys and values quantized per position,
    padded key slots (-1), the second row's keys all in another segment so
    that its query rows see no key and are written 0; within 1e-5."""
    rng = np.random.default_rng(q_offset + sq)
    B, Hq, Hkv, Skv, D = 2, 4, 2, q_offset + sq, 8
    q = rng.normal(size=(B, Hq, sq, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32)
            for _ in range(2))
    kq, ks = jl.quantize_kv(jnp.asarray(k))
    vq, vs = jl.quantize_kv(jnp.asarray(v))
    q_seg = np.zeros((B, sq), np.int32)
    kv_seg = np.zeros((B, Skv), np.int32)
    kv_seg[0, :2] = -1
    kv_seg[1] = 1
    want = jl.cache_attention(jnp.asarray(q), kq, vq, ks, vs,
                              q_offset=q_offset,
                              q_segment_ids=jnp.asarray(q_seg),
                              kv_segment_ids=jnp.asarray(kv_seg))
    t = lambda a: torch.from_numpy(np.array(a))
    got = tl.cache_attention(t(q), t(kq), t(vq), t(ks), t(vs),
                             q_offset=q_offset, q_segment_ids=t(q_seg),
                             kv_segment_ids=t(kv_seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert not got[1].any() and got[0].abs().max() > 0.1


def test_int8_cache_bytes_are_half_of_bf16():
    """The int8 buffers and their scales against a bf16 cache of the 7B
    decoder's shape per layer (Hkv 4, D 128): (2 + 8 / 128) / 4 of it."""
    a = tl.KVCache.create(1, 1, 4, 256, 128, dtype=torch.int8)
    b = tl.KVCache.create(1, 1, 4, 256, 128, dtype=torch.bfloat16)
    nbytes = lambda c: sum(x.numel() * x.element_size() for x in (
        c.k, c.v, c.k_scale, c.v_scale) if x is not None)
    assert nbytes(a) / nbytes(b) == (2 + 8 / 128) / 4


@pytest.fixture(scope="module")
def m8():
    """test_torch_generation's tree and right-padded M-RoPE prompt, both
    generators over an int8 cache."""
    params = jllm.init_llm_params(jax.random.PRNGKey(3), JaxLLMConfig(**KW))
    model = tllm.Qwen2Decoder(LLMConfig(**KW), params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"))
    ids = np.random.default_rng(0).integers(1, KW["vocab_size"] - 1, (1, S))
    pos = np.broadcast_to(np.arange(S)[None, None], (3, 1, S)).copy()
    return SimpleNamespace(
        jg=jgen.Generator(params, JaxLLMConfig(**KW), max_len=128,
                          cache_dtype=jnp.int8),
        tg=tgen.Generator(model, max_len=128, cache_dtype=torch.int8,
                          gumbel=jax_gumbel),
        params=params, model=model, ids=ids, pos=pos,
        embeds=np.array(jllm.embed_tokens(params, jnp.asarray(ids))),
        seg=np.where(np.arange(S)[None] < REAL, 0, -1).astype(np.int32))


def test_int8_greedy_stepwise_and_f32_agreement(m8):
    want, got = both(m8, max_new_tokens=10)
    assert got == want and len(got) == 10
    _, stepwise = both(m8, max_new_tokens=10, call=dict(stream=True))
    assert stepwise == want
    f32 = tgen.Generator(m8.model, max_len=128, cache_dtype=torch.float32)
    plain = f32.generate(torch.from_numpy(m8.embeds), torch.from_numpy(m8.pos),
                         tgen.GenerationConfig(max_new_tokens=10),
                         decode_pos_start=REAL, last_real_idx=REAL - 1,
                         segment_ids=torch.from_numpy(m8.seg))
    assert sum(a == b for a, b in zip(plain, got)) >= len(got) - 1


@pytest.mark.parametrize("kw", [
    dict(max_new_tokens=10, temperature=0.7, top_k=5),
    dict(max_new_tokens=10, preemptible_chunk=3),
    dict(max_new_tokens=6, preemptible_chunk=2, prefill_chunk=5),
    dict(max_new_tokens=6, preemptible_chunk=2, prefill_chunk=8),
], ids=["sampled", "preemptible", "prefill_chunk5", "prefill_chunk8"])
def test_int8_paths_match_jax(m8, kw):
    want, got = both(m8, **kw)
    assert got == want and len(got) == kw["max_new_tokens"]


def test_int8_speculation_matches_jax(m8):
    greedy, _ = both(m8, max_new_tokens=12)
    prompt = m8.ids[0, :REAL]
    spec = dict(max_new_tokens=12, speculative_k=3, speculative_ngram=2)
    for ctx in (prompt, np.concatenate([prompt, greedy, prompt])):
        want, got = both(m8, **spec, call=dict(context_ids=ctx))
        assert got == want == greedy
    assert m8.tg.last_spec["accepted"] > 0


def test_int8_generate_batch_matches_jax(m8):
    B, L = 2, 16
    rng = np.random.default_rng(5)
    ids = rng.integers(1, KW["vocab_size"] - 1, (B, L))
    embeds = np.array(jllm.embed_tokens(m8.params, jnp.asarray(ids)))
    pad = np.array([0, 5])
    seg = np.where(np.arange(L)[None] >= pad[:, None], 0, -1).astype(np.int32)
    pos = np.maximum(np.arange(L)[None] - pad[:, None], 0)
    pos = np.broadcast_to(pos[None], (3, B, L)).copy()
    want = m8.jg.generate_batch(jnp.asarray(embeds), jnp.asarray(pos),
                                jnp.asarray(seg),
                                jgen.GenerationConfig(max_new_tokens=6),
                                jnp.asarray(L - pad))
    got = m8.tg.generate_batch(torch.from_numpy(embeds), torch.from_numpy(pos),
                               torch.from_numpy(seg),
                               tgen.GenerationConfig(max_new_tokens=6),
                               torch.from_numpy(L - pad))
    assert got == [[int(t) for t in r] for r in want]


def test_int8_decode_multi_matches_jax(m8):
    """5 tokens against an int8 cache holding the padded prompt in one
    decode_multi forward: hidden states within ATOL of JAX's, and the
    cache's int8 values equal to JAX's where written."""
    params, cfg = m8.params, JaxLLMConfig(**KW)
    new = np.random.default_rng(9).integers(1, 63, (1, 5))
    emb_new = np.array(jllm.embed_tokens(params, jnp.asarray(new)))
    pos_new = np.broadcast_to(np.arange(S, S + 5)[None, None], (3, 1, 5))
    jc = jl.KVCache.create(cfg.num_layers, 1, cfg.num_kv_heads, 64,
                           cfg.head_dim, jnp.int8)
    _, jc = jllm.decoder_forward(params, cfg, jnp.asarray(m8.embeds),
                                 jnp.asarray(m8.pos), cache=jc,
                                 segment_ids=jnp.asarray(m8.seg))
    want, jc = jllm.decoder_forward(params, cfg, jnp.asarray(emb_new),
                                    jnp.asarray(pos_new), cache=jc,
                                    decode_multi=True)
    tc = m8.tg.new_cache(1, 64)
    with torch.no_grad():
        m8.model(torch.from_numpy(m8.embeds), torch.from_numpy(m8.pos),
                 segment_ids=torch.from_numpy(m8.seg), cache=tc)
        got = m8.model(torch.from_numpy(emb_new),
                       torch.from_numpy(pos_new.copy()), cache=tc,
                       decode_multi=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    n = S + 5
    assert tc.length == int(jc.length) == n
    for name in ("k", "v"):
        np.testing.assert_array_equal(getattr(tc, name)[..., :n, :].numpy(),
                                      np.asarray(getattr(jc, name))[..., :n, :])
    np.testing.assert_allclose(tc.k_scale[..., :n, :].numpy(),
                               np.asarray(jc.k_scale)[..., :n, :], rtol=1e-5)


def test_int8_eos_and_stop(m8):
    greedy, _ = both(m8, max_new_tokens=8)
    want, got = both(m8, max_new_tokens=8, eos_token_ids=(greedy[2],),
                     preemptible_chunk=2)
    assert got == want == greedy[:greedy.index(greedy[2]) + 1]
