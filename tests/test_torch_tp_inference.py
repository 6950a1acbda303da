"""The port's tensor-parallel decode (flash_vstream_tpu_torch/parallel/)
held against the JAX package's on its 8-device virtual CPU mesh: the
sharding rules leaf for leaf, the sharded forward's logits, the sharded
Generator's ids, and quantized bases. The port's shards run on repeated
CPU entries (["cpu"] * tp), its collectives as tensor adds in rank order;
every input comes from a numpy seed, every tree from the JAX init.

Two planted faults (shards that read the wrong kv heads, a dropped
partial in the all-reduce) are shown to fail the logit check.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flash_vstream_tpu.core.config import LLMConfig as JLLMConfig
from flash_vstream_tpu.core.config import tiny_qwen_config as jtiny_qwen
from flash_vstream_tpu.models.llm import decoder_forward as jforward
from flash_vstream_tpu.models.llm import embed_tokens as jembed
from flash_vstream_tpu.models.llm import init_llm_params as jinit_llm
from flash_vstream_tpu.models.llm import lm_head as jlm_head
from flash_vstream_tpu.models.vstream_qwen import init_qwen_params
from flash_vstream_tpu.parallel import sharding as jsharding
from flash_vstream_tpu.parallel.inference import (
    shard_params_for_inference as jshard)
from flash_vstream_tpu.runtime.generation import GenerationConfig as JGen
from flash_vstream_tpu.runtime.generation import Generator as JGenerator
from flash_vstream_tpu.weights import quantize as jquant

from flash_vstream_tpu_torch.core.config import LLMConfig, tiny_qwen_config
from flash_vstream_tpu_torch.models.llm import Qwen2Decoder
from flash_vstream_tpu_torch.parallel import inference, sharding
from flash_vstream_tpu_torch.parallel.inference import (
    TPKVCache, shard_params_for_inference)
from flash_vstream_tpu_torch.runtime.generation import (GenerationConfig,
                                                        Generator)
from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy

torch.set_num_threads(1)

# the JAX package's tensor-parallel test config (tests/test_tp_inference.py)
KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
          num_layers=2, num_heads=8, num_kv_heads=4)
RTOL = 2e-3          # test_tp_forward_matches' tolerance, rtol and atol
CONFIGS = {"llm": (JLLMConfig(**KW), LLMConfig(**KW)),
           "qwen": (jtiny_qwen().llm, tiny_qwen_config().llm)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    """JAX trees and the port's decoders over the same numbers, per
    config: (JAX params, port Qwen2Decoder)."""
    out = {}
    for name, (jcfg, cfg) in CONFIGS.items():
        jp = jinit_llm(jax.random.PRNGKey(0), jcfg)
        if jcfg.attention_bias:   # nonzero biases: their split shows
            key = jax.random.PRNGKey(1)
            for w in ("wq", "wk", "wv"):
                key, sub = jax.random.split(key)
                b = jp["layers"]["attn"][w]["b"]
                jp["layers"]["attn"][w]["b"] = jax.random.normal(sub, b.shape)
        out[name] = (jp, Qwen2Decoder(cfg, params_from_numpy(_np(jp), "cpu")))
    return out


def _cpu_mesh(tp):
    return sharding.create_mesh(dp=1, tp=tp, devices=["cpu"] * tp)


def _tp(dec, tp):
    return shard_params_for_inference(dec, mesh=_cpu_mesh(tp))[0]


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def _jax_specs(shardings):
    flat, _ = jax.tree_util.tree_flatten_with_path(shardings)
    return {jsharding.path_str(p): tuple(s.spec) for p, s in flat}


def _port_specs(specs):
    out = {}

    def walk(t, prefix):
        if isinstance(t, sharding.PartitionSpec):
            out["/".join(map(str, prefix))] = tuple(t)
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, prefix + (k,))
        elif hasattr(t, "_fields"):
            for k in t._fields:
                walk(getattr(t, k), prefix + (f".{k}",))
        else:
            for i, v in enumerate(t):
                walk(v, prefix + (i,))
    walk(specs, ())
    return out


def _tree(kind):
    if kind == "qwen":
        return init_qwen_params(jax.random.PRNGKey(0), jtiny_qwen())
    p = jinit_llm(jax.random.PRNGKey(0), CONFIGS["llm"][0])
    if kind == "llm_int8":
        return jquant.quantize_params(p)
    if kind == "llm_int4":
        return jquant.quantize_params4(p, block=32)
    return p


MESHES = {"dp1_tp8": (1, 8), "dp2_tp4": (2, 4), "dp8_tp1": (8, 1),
          "train_dp2_pp4": None}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kind", ["llm", "qwen", "llm_int8", "llm_int4"])
def test_rules_match_jax(kind, mesh):
    """param_shardings and zero_shardings give every leaf (a quantized
    leaf's fields too) JAX's spec on the same 8-device mesh."""
    jdevs = jax.devices()[:8]
    if MESHES[mesh] is None:
        jm = jsharding.create_train_mesh(dp=2, pp=4, devices=jdevs)
        tm = sharding.create_train_mesh(dp=2, pp=4, devices=["cpu"] * 8)
    else:
        dp, tp = MESHES[mesh]
        jm = jsharding.create_mesh(dp=dp, tp=tp, devices=jdevs)
        tm = sharding.create_mesh(dp=dp, tp=tp, devices=["cpu"] * 8)
    assert tm.axis_names == jm.axis_names and tm.shape == dict(jm.shape)
    jp = _tree(kind)
    tp_tree = params_from_numpy(_np(jp), "cpu")
    for fn in ("param_shardings", "zero_shardings"):
        want = _jax_specs(getattr(jsharding, fn)(jm, jp))
        got = _port_specs(getattr(sharding, fn)(tm, tp_tree))
        assert got == want, fn
    if kind.startswith("llm_int"):     # quantized fields stay whole
        assert _port_specs(sharding.param_shardings(tm, tp_tree))[
            "layers/attn/wq/w/.q" + ("4" if kind.endswith("4") else "")] == ()
    assert sharding.batch_sharding(tm) == tuple(jsharding.batch_sharding(
        jm).spec)
    assert sharding.replicated(tm) == tuple(jsharding.replicated(jm).spec)


def test_mesh_of_the_visible_cards_needs_a_card(monkeypatch):
    """With no devices given the mesh is the visible cards; without one it
    raises, as the port's entry points do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sharding.create_mesh(tp=1)
    m = sharding.create_mesh(dp=2, tp=2, devices=["cpu"] * 5)
    assert m.shape == {"dp": 2, "tp": 2} and m.devices.size == 4
    with pytest.raises(ValueError):
        sharding.create_mesh(dp=2, tp=4, devices=["cpu"] * 5)


# ---------------------------------------------------------------------------
# the sharded forward and Generator against JAX's
# ---------------------------------------------------------------------------

def _jax_sharded_logits(jp, jcfg, ids, pos, tp):
    sharded, mesh = jshard(jp, tp=tp)
    with mesh:
        h, _ = jax.jit(lambda p, e, q: jforward(p, jcfg, e, q))(
            sharded, jembed(sharded, ids), pos)
        return np.asarray(jlm_head(sharded, jcfg, h))


def _port_logits(dec, ids, pos):
    return dec.logits(dec(dec.embed_tokens(ids), pos)).numpy()


@pytest.mark.parametrize("name,tp", [("llm", 2), ("llm", 4), ("llm", 8),
                                     ("qwen", 2), ("qwen", 4)])
def test_tp_forward_matches_jax(trees, rng, name, tp):
    """The sharded forward's logits are JAX's sharded forward's (tp 8 over
    the llm config's 4 kv heads, tp 4 over the Qwen config's 2: each kv
    head on tp / Hkv shards), and the port's one-device logits."""
    jp, dec = trees[name]
    jcfg = CONFIGS[name][0]
    ids_np = rng.integers(0, jcfg.vocab_size, size=(1, 10))
    pos_np = np.arange(10)[None]
    want = _jax_sharded_logits(jp, jcfg, jnp.asarray(ids_np),
                               jnp.asarray(pos_np), tp)
    tpd = _tp(dec, tp)
    ids, pos = torch.from_numpy(ids_np), torch.from_numpy(pos_np)
    got = _port_logits(tpd, ids, pos)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(got, _port_logits(dec, ids, pos),
                               rtol=RTOL, atol=RTOL)
    # the shards hold their heads: q heads Hq / tp, kv heads at least one
    cfg = dec.cfg
    for s in tpd.shards:
        a = s["layers"]["attn"]
        assert a["wq"]["w"].shape[-1] == cfg.num_heads // tp * cfg.head_dim
        assert a["wk"]["w"].shape[-1] == max(
            cfg.num_kv_heads // tp, 1) * cfg.head_dim
        assert a["wo"]["w"].shape[-2] == cfg.num_heads // tp * cfg.head_dim
        assert s["embed"].shape[0] == cfg.vocab_size // tp


def test_tp8_greedy_ids_match_jax(trees, rng):
    """JAX's test_tp_generation_matches: greedy ids at tp 8 with an f32
    cache equal the JAX sharded Generator's and the one-device ones."""
    jp, dec = trees["llm"]
    jcfg = CONFIGS["llm"][0]
    emb = rng.normal(size=(1, 6, 64)).astype(np.float32)
    sharded, mesh = jshard(jp, tp=8)
    with mesh:
        want = JGenerator(sharded, jcfg, max_len=64,
                          cache_dtype=jnp.float32).generate(
            jnp.asarray(emb), jnp.arange(6)[None],
            JGen(max_new_tokens=8, eos_token_ids=()))
    gen = GenerationConfig(max_new_tokens=8)
    args = (torch.from_numpy(emb), torch.arange(6)[None], gen)
    got = Generator(_tp(dec, 8), 64, torch.float32).generate(*args)
    assert got == [int(t) for t in want]
    assert got == Generator(dec, 64, torch.float32).generate(*args)


PATHS = {
    "greedy": dict(),
    "stream": dict(stream=True),
    "preemptible_prefill_chunks": dict(preemptible_chunk=3, prefill_chunk=4),
    "speculative": dict(speculative_k=3, speculative_ngram=2),
    "sampled": dict(temperature=0.8, top_k=20, seed=3),
    "int8_cache": dict(),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_every_generator_path_over_the_shard_caches(trees, rng, path):
    """Each Generator path the session takes (one-shot and chunked prefill,
    step, the preemptible chunks, the speculative verify with its length
    set back, the stepwise stream, sampling, the int8 cache) gives the
    one-device ids over the per-shard caches (Qwen config, tp 4: two
    shards a kv head, M-RoPE, biases)."""
    _, dec = trees["qwen"]
    tpd = _tp(dec, 4)
    kw = dict(PATHS[path])
    stream = kw.pop("stream", False)
    dtype = torch.int8 if path == "int8_cache" else torch.float32
    gen = GenerationConfig(max_new_tokens=10, **kw)
    emb = torch.from_numpy(rng.normal(size=(1, 9, 64)).astype(np.float32))
    pos = torch.arange(9)[None].expand(3, 1, 9)
    ctx = rng.integers(0, 512, size=12)
    ctx[-4:] = ctx[:4]         # a repeated n-gram: drafts get accepted

    def ids(d):
        g = Generator(d, 64, dtype)
        return g.generate(emb, pos, gen, stream=stream,
                          context_ids=ctx if gen.speculative_k else None)
    want, got = ids(dec), ids(tpd)
    assert got == want and len(got) == 10
    cache = Generator(tpd, 64, dtype).new_cache(1, 16)
    assert isinstance(cache, TPKVCache) and len(cache.shards) == 4
    assert [c.k.shape[2] for c in cache.shards] == [1] * 4
    cache.length = 5
    assert {c.length for c in cache.shards} == {5}
    assert {c.quantized for c in cache.shards} == {dtype == torch.int8}


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_base_at_tp2(trees, rng, bits):
    """An int8 or int4 base (JAX quantizes, then places: its fields match
    no rule and stay whole): the port's tp-2 ids equal its one-device ids
    and JAX's sharded ones. The whole weights run one product on the first
    device (wo and down over the gathered heads), so the logits are the
    one-device logits bit for bit."""
    jp, _ = trees["llm"]
    jcfg, cfg = CONFIGS["llm"]
    jq = (jquant.quantize_params(jp) if bits == 8
          else jquant.quantize_params4(jp, block=32))
    dec = Qwen2Decoder(cfg, params_from_numpy(_np(jq), "cpu"))
    tpd = _tp(dec, 2)
    assert hasattr(tpd.shards[1]["layers"]["mlp"]["down"]["w"], "scale")
    emb = rng.normal(size=(1, 6, 64)).astype(np.float32)
    sharded, mesh = jshard(jq, tp=2)
    with mesh:
        want = JGenerator(sharded, jcfg, max_len=64,
                          cache_dtype=jnp.float32).generate(
            jnp.asarray(emb), jnp.arange(6)[None],
            JGen(max_new_tokens=8, eos_token_ids=()))
    args = (torch.from_numpy(emb), torch.arange(6)[None],
            GenerationConfig(max_new_tokens=8))
    got = Generator(tpd, 64, torch.float32).generate(*args)
    assert got == [int(t) for t in want]
    assert got == Generator(dec, 64, torch.float32).generate(*args)
    ids = torch.from_numpy(rng.integers(0, 128, size=(1, 10)))
    pos = torch.arange(10)[None]
    assert np.array_equal(_port_logits(tpd, ids, pos),
                          _port_logits(dec, ids, pos))


def _wrong_kv_heads(path, n, tp, cfg):
    """Every shard reads kv head 0 (no Megatron replication map)."""
    cuts = _CUTS(path, n, tp, cfg)
    if "attn/wk" in path or "attn/wv" in path:
        w = cuts[0][1] - cuts[0][0]
        return [(0, w)] * tp
    return cuts


_CUTS = inference._cuts


def _drop_last_partial(self, parts):
    return _ALL_REDUCE(self, parts[:-1])


_ALL_REDUCE = inference.TPGroup.all_reduce


@pytest.mark.parametrize("fault", ["wrong_kv_heads", "dropped_partial"])
def test_planted_fault_fails_the_logit_check(trees, rng, monkeypatch,
                                             fault):
    """The tp-8 logit check catches shards that read the wrong kv heads,
    and an all-reduce that leaves one shard's partial out."""
    jp, dec = trees["llm"]
    jcfg = CONFIGS["llm"][0]
    ids_np = rng.integers(0, 128, size=(1, 10))
    pos_np = np.arange(10)[None]
    want = _jax_sharded_logits(jp, jcfg, jnp.asarray(ids_np),
                               jnp.asarray(pos_np), 8)
    if fault == "wrong_kv_heads":
        monkeypatch.setattr(inference, "_cuts", _wrong_kv_heads)
    else:
        monkeypatch.setattr(inference.TPGroup, "all_reduce",
                            _drop_last_partial)
    got = _port_logits(_tp(dec, 8), torch.from_numpy(ids_np),
                       torch.from_numpy(pos_np))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)


def test_tp_must_fit_the_heads(trees):
    """tp 3 splits neither 8 q heads nor 4 kv heads: refused; so is a
    mesh with a dp axis over 1."""
    _, dec = trees["llm"]
    with pytest.raises(ValueError, match="tp 3"):
        _tp(dec, 3)
    with pytest.raises(ValueError, match="tp"):
        shard_params_for_inference(
            dec, mesh=sharding.create_mesh(dp=2, tp=2, devices=["cpu"] * 4))
