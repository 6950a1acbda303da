"""The port's generation paths (runtime/generation.py) held against the JAX
Generator on one parameter tree, in f32 on the CPU with an f32 KV cache
(as tests/test_generation.py runs JAX): token ids must be exact.

Sampling takes JAX's draws: jax.random.categorical(key, logits) is
argmax(logits + gumbel(key, logits.shape)), so the port's Generator is
handed the Gumbel noise of JAX's key chain (PRNGKey(seed) for the first
token, then one split a token) and must pick the same ids. The
decode_multi forward (k + 1 tokens against a cache prefix) is held to JAX's
`decoder_forward(decode_multi=True)` within ATOL.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_vstream_tpu.core.config import LLMConfig as JaxLLMConfig
from flash_vstream_tpu.models import llm as jllm
from flash_vstream_tpu.models.layers import KVCache as JaxKVCache
from flash_vstream_tpu.preprocess.tokenizer import (
    ByteTokenizer as JaxByteTokenizer,
    KeywordsStoppingCriteria as JaxKeywords)
from flash_vstream_tpu.runtime import generation as jgen
from flash_vstream_tpu_torch.core.config import LLMConfig
from flash_vstream_tpu_torch.models import llm as tllm
from flash_vstream_tpu_torch.preprocess.tokenizer import (
    ByteTokenizer, KeywordsStoppingCriteria)
from flash_vstream_tpu_torch.runtime import generation as tgen
from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy

torch.set_num_threads(1)
ATOL = 1e-4
# head_dim 8: M-RoPE sections over head_dim // 2
KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
          num_heads=4, num_kv_heads=2, mrope_sections=(1, 1, 2),
          rope_theta=1e6, attention_bias=True)
S, REAL = 24, 19


def jax_gumbel(gen, shape, device):
    """JAX's sampling noise, token by token (generation.py:515-529)."""
    key = jax.random.PRNGKey(gen.seed)
    sub = key
    while True:
        yield torch.from_numpy(np.array(
            jax.random.gumbel(sub, shape, jnp.float32))).to(device)
        key, sub = jax.random.split(key)


@pytest.fixture(scope="module")
def m():
    """JAX and port generators on one tree; a right-padded M-RoPE prompt."""
    jcfg, tcfg = JaxLLMConfig(**KW), LLMConfig(**KW)
    params = jllm.init_llm_params(jax.random.PRNGKey(3), jcfg)
    model = tllm.Qwen2Decoder(tcfg, params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"))
    jg = jgen.Generator(params, jcfg, max_len=128, cache_dtype=jnp.float32)
    tg = tgen.Generator(model, max_len=128, cache_dtype=torch.float32,
                        gumbel=jax_gumbel)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, KW["vocab_size"] - 1, (1, S))
    embeds = np.array(jllm.embed_tokens(params, jnp.asarray(ids)))
    pos = np.broadcast_to(np.arange(S)[None, None], (3, 1, S)).copy()
    seg = np.where(np.arange(S)[None] < REAL, 0, -1).astype(np.int32)
    return dataclasses.make_dataclass("M", [
        "jg", "tg", "params", "model", "ids", "embeds", "pos", "seg"])(
        jg, tg, params, model, ids, embeds, pos, seg)


def both(m, **kw):
    """(JAX ids, port ids) of one generate() call on the padded prompt;
    kw goes to both GenerationConfigs, `call` to both generate()s."""
    call = kw.pop("call", {})
    jcall = {k: (JaxKeywords(v.keywords, JaxByteTokenizer())
                 if k == "stopping" else v) for k, v in call.items()}
    args = dict(decode_pos_start=REAL, last_real_idx=REAL - 1)
    want = m.jg.generate(jnp.asarray(m.embeds), jnp.asarray(m.pos),
                         jgen.GenerationConfig(**kw),
                         segment_ids=jnp.asarray(m.seg), **args, **jcall)
    got = m.tg.generate(torch.from_numpy(m.embeds), torch.from_numpy(m.pos),
                        tgen.GenerationConfig(**kw),
                        segment_ids=torch.from_numpy(m.seg), **args, **call)
    return [int(t) for t in want], got


def test_greedy_stepwise_and_top_k_one(m):
    want, got = both(m, max_new_tokens=10)
    assert got == want and len(got) == 10
    _, stepwise = both(m, max_new_tokens=10, call=dict(stream=True))
    _, top1 = both(m, max_new_tokens=10, temperature=1.0, top_k=1)
    assert stepwise == top1 == want


@pytest.mark.parametrize("max_new", [1, 3])
def test_eos_and_max_new_tokens(m, max_new):
    greedy, _ = both(m, max_new_tokens=8)
    want, got = both(m, max_new_tokens=8, eos_token_ids=(greedy[2],))
    assert got == want == greedy[:greedy.index(greedy[2]) + 1]
    want, got = both(m, max_new_tokens=max_new)
    assert got == want and len(got) == max_new


def _tied_logits(rng, k):
    """[3, 64] logits where the k-th largest of each row is tied with its
    neighbours, so top-k keeps every copy of the tie."""
    lg = rng.normal(size=(3, 64)).astype(np.float32) * 2
    for r in range(3):
        order = np.argsort(-lg[r])
        lg[r, order[max(k - 2, 0):k + 2]] = lg[r, order[k - 1]]
    return lg


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.8), (0.9, 5, 0.7),
    (2.0, 2, 0.95), (1.0, 1, 0.5), (0.0, 5, 0.5)])
def test_sample_grid_with_jax_draws(temperature, top_k, top_p):
    rng = np.random.default_rng(int(temperature * 10) + top_k)
    lg = _tied_logits(rng, max(top_k, 3))
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jgen._sample(jnp.asarray(lg),
                                       jgen.GenerationConfig(**kw), key))
        g = torch.from_numpy(np.array(
            jax.random.gumbel(key, lg.shape, jnp.float32)))
        got = tgen._sample(torch.from_numpy(lg), tgen.GenerationConfig(**kw),
                           None if temperature <= 0 or top_k == 1 else g)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(seed))


def test_sample_filters():
    """top-k keeps every copy of a tie at the k-th logit; top-p keeps the
    smallest prefix with mass >= top_p; the noise never revives a filtered
    token."""
    lg = torch.tensor([[3.0, 2.0, 2.0, 2.0, -1.0, -5.0]])
    big = torch.tensor([[0.0, 0.0, 0.0, 0.0, 100.0, 100.0]])
    gen = tgen.GenerationConfig(temperature=1.0, top_k=2)
    for j in range(4):
        noise = torch.zeros(1, 6)
        noise[0, j] = 50.0
        assert int(tgen._sample(lg, gen, noise)) == j
    assert int(tgen._sample(lg, gen, big)) in (0, 1, 2, 3)
    # softmax mass of the top logit 0.47: top_p 0.4 keeps it alone, 0.5
    # keeps the tie after it too
    near = big + torch.tensor([[0.0, 90.0, 0.0, 0.0, 0.0, 0.0]])
    for top_p, want in ((0.4, 0), (0.5, 1)):
        gen = tgen.GenerationConfig(temperature=1.0, top_p=top_p)
        assert int(tgen._sample(lg, gen, near)) == want


@pytest.mark.parametrize("seed", [0, 7])
def test_sampled_generate_and_stream_match_jax(m, seed):
    kw = dict(max_new_tokens=8, temperature=0.9, top_k=20, top_p=0.95,
              seed=seed)
    want, got = both(m, **kw)
    assert got == want and len(got) == 8
    args = dict(decode_pos_start=REAL, last_real_idx=REAL - 1)
    jstream = list(m.jg.generate_stream(
        jnp.asarray(m.embeds), jnp.asarray(m.pos), jgen.GenerationConfig(**kw),
        segment_ids=jnp.asarray(m.seg), **args))
    tstream = list(m.tg.generate_stream(
        torch.from_numpy(m.embeds), torch.from_numpy(m.pos),
        tgen.GenerationConfig(**kw), segment_ids=torch.from_numpy(m.seg),
        **args))
    assert tstream == [int(t) for t in jstream] == got


def test_default_draws_are_seeded(m):
    """Without JAX's draws the Generator samples from a torch generator
    seeded with gen.seed: the same seed gives the same ids."""
    g = tgen.Generator(m.model, max_len=128, cache_dtype=torch.float32)
    gen = tgen.GenerationConfig(max_new_tokens=8, temperature=1.5, seed=3)
    args = (torch.from_numpy(m.embeds), torch.from_numpy(m.pos), gen)
    kw = dict(segment_ids=torch.from_numpy(m.seg), last_real_idx=REAL - 1)
    assert g.generate(*args, **kw) == g.generate(*args, **kw)


@pytest.mark.parametrize("chunk", [1, 3, 4, 16])
def test_preemptible_chunks(m, chunk):
    greedy, _ = both(m, max_new_tokens=10)
    want, got = both(m, max_new_tokens=10, preemptible_chunk=chunk)
    assert got == want == greedy


def test_preemptible_eos_mid_chunk(m):
    greedy, _ = both(m, max_new_tokens=8)
    eos = (greedy[2],)
    fused, _ = both(m, max_new_tokens=8, eos_token_ids=eos)
    want, got = both(m, max_new_tokens=8, eos_token_ids=eos,
                     preemptible_chunk=2)
    assert got == want == fused


@pytest.mark.parametrize("chunk", [5, 8, 24, 32])
def test_prefill_chunks(m, chunk):
    """The last real token (18) lies in a middle chunk at 5 ([15, 20) of
    five chunks) and in the last at 8."""
    greedy, _ = both(m, max_new_tokens=6, preemptible_chunk=2)
    want, got = both(m, max_new_tokens=6, preemptible_chunk=2,
                     prefill_chunk=chunk)
    assert got == want == greedy


def test_speculation_matches_greedy_and_jax(m):
    greedy, _ = both(m, max_new_tokens=12)
    spec = dict(max_new_tokens=12, speculative_k=3, speculative_ngram=2)
    prompt = m.ids[0, :REAL]
    # a cold context, then one seeded with the answer so drafts accept
    for ctx in (prompt, np.concatenate([prompt, greedy, prompt])):
        want, got = both(m, **spec, call=dict(context_ids=ctx))
        assert got == want == greedy
    assert m.tg.last_spec["accepted"] > 0
    eos = (greedy[3],)
    base, _ = both(m, max_new_tokens=12, eos_token_ids=eos)
    want, got = both(m, **spec, eos_token_ids=eos, call=dict(context_ids=ctx))
    assert got == want == base
    # with preemption set too, speculation runs (and warns once)
    _, got = both(m, **spec, preemptible_chunk=4, call=dict(context_ids=ctx))
    assert got == greedy


def test_stop_keywords(m):
    """A one-token keyword folds into the greedy loop's EOS set; a longer
    one stops the stepwise loop once the text holds it."""
    greedy, _ = both(m, max_new_tokens=10, call=dict(stream=True))
    tok = ByteTokenizer()
    one = KeywordsStoppingCriteria([chr(greedy[3])], tok)
    two = KeywordsStoppingCriteria([chr(greedy[4]) + chr(greedy[5])], tok)
    jone = JaxKeywords(one.keywords, JaxByteTokenizer())
    assert one.single_token_ids() == jone.single_token_ids() == (greedy[3],)
    assert two.single_token_ids() == ()
    for crit in (one, two):
        for t in range(1, 8):
            assert crit.should_stop(greedy[:t]) == JaxKeywords(
                crit.keywords, JaxByteTokenizer()).should_stop(greedy[:t])
    want, got = both(m, max_new_tokens=10, call=dict(stopping=one))
    assert got == want == greedy[:greedy.index(greedy[3]) + 1]
    want, got = both(m, max_new_tokens=10, call=dict(stopping=two,
                                                      stream=True))
    assert got == want
    assert two.should_stop(got) and len(got) <= 6


def test_generate_batch_left_padded(m):
    """Two left-padded rows, per-row decode positions, one row's EOS."""
    B, L = 2, 16
    rng = np.random.default_rng(5)
    ids = rng.integers(1, KW["vocab_size"] - 1, (B, L))
    embeds = np.array(jllm.embed_tokens(m.params, jnp.asarray(ids)))
    pad = np.array([0, 5])
    seg = np.where(np.arange(L)[None] >= pad[:, None], 0, -1).astype(np.int32)
    pos = np.maximum(np.arange(L)[None] - pad[:, None], 0)
    pos = np.broadcast_to(pos[None], (3, B, L)).copy()
    start = L - pad
    for eos in ((), None):
        jcfg = jgen.GenerationConfig(max_new_tokens=6, eos_token_ids=eos or ())
        want = m.jg.generate_batch(jnp.asarray(embeds), jnp.asarray(pos),
                                   jnp.asarray(seg), jcfg, jnp.asarray(start))
        if eos is None:        # the second row's third token ends it
            eos = (want[1][2],)
            jcfg = jgen.GenerationConfig(max_new_tokens=6, eos_token_ids=eos)
            want = m.jg.generate_batch(jnp.asarray(embeds), jnp.asarray(pos),
                                       jnp.asarray(seg), jcfg,
                                       jnp.asarray(start))
        got = m.tg.generate_batch(
            torch.from_numpy(embeds), torch.from_numpy(pos),
            torch.from_numpy(seg), tgen.GenerationConfig(
                max_new_tokens=6, eos_token_ids=eos), torch.from_numpy(start))
        assert got == [[int(t) for t in r] for r in want]
    assert len(got[1]) <= 3


def test_decode_multi_logits_match_jax(m):
    """k + 1 = 5 tokens against a cache holding the padded prompt, in one
    decode_multi forward: hidden states within ATOL of JAX's, and equal to
    the one-shot forward of the whole sequence at those positions."""
    params, cfg = m.params, JaxLLMConfig(**KW)
    new = np.random.default_rng(9).integers(1, 63, (1, 5))
    emb_new = np.array(jllm.embed_tokens(params, jnp.asarray(new)))
    pos_new = np.broadcast_to(np.arange(S, S + 5)[None, None], (3, 1, 5))
    jc = JaxKVCache.create(cfg.num_layers, 1, cfg.num_kv_heads, 64,
                           cfg.head_dim, jnp.float32)
    _, jc = jllm.decoder_forward(params, cfg, jnp.asarray(m.embeds),
                                 jnp.asarray(m.pos), cache=jc,
                                 segment_ids=jnp.asarray(m.seg))
    want, jc = jllm.decoder_forward(params, cfg, jnp.asarray(emb_new),
                                    jnp.asarray(pos_new), cache=jc,
                                    decode_multi=True)
    tc = m.tg.new_cache(1, 64)
    with torch.no_grad():
        m.model(torch.from_numpy(m.embeds), torch.from_numpy(m.pos),
                segment_ids=torch.from_numpy(m.seg), cache=tc)
        got = m.model(torch.from_numpy(emb_new),
                      torch.from_numpy(pos_new.copy()), cache=tc,
                      decode_multi=True)
        with pytest.raises(ValueError, match="decode_multi"):
            m.model(torch.from_numpy(emb_new),
                    torch.from_numpy(pos_new.copy()), cache=tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(
        m.model.logits(got).numpy(),
        np.asarray(jllm.lm_head(params, cfg, want)), atol=ATOL)
    assert tc.length == int(jc.length) == S + 5
    np.testing.assert_array_equal(tc.segments.numpy(),
                                  np.asarray(jc.segments))
