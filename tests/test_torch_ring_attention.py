"""Ring attention across ranks (flash_vstream_tpu_torch/parallel/sequence.py)
against JAX's ring on its virtual CPU mesh, full attention and the plain
decoder.

The port runs in gloo ranks on the CPU (two spawns: world 2 for sp 2,
world 4 for sp 4 and dp 2 x sp 2); JAX's functions run in this process
over the same sp (and dp) widths. `ring_attention_local` (causal; with
two documents and padding) against JAX's ring and `xla_attention` within
2e-5 (test_sequence_parallel.py's limits, valid rows). `sp_decoder_forward`
with M-RoPE positions, segments and labels whose valid counts differ
between the shards: each rank's chunk of the hidden states against JAX's
and the plain decoder's within 2e-5, the loss (the shards' nll sums over
their summed counts, a token mean over every rank) within 1e-5 relative of
JAX's cross entropy over the gathered hidden states, which a mean of the
shards' means misses by more than that, and every leaf's gradient (summed
over the ring, averaged over dp) within 5e-4 relative and 5e-5 absolute of
jax.grad through JAX's ring (at 28 layers, as test_pp_sp_training.py holds
only the loss there, through JAX's plain decoder, which compiles in a
fraction of the ring's time)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_ranks
from flash_vstream_tpu.core.config import LLMConfig
from flash_vstream_tpu.kernels.flash_attention import xla_attention
from flash_vstream_tpu.models.llm import (cross_entropy_loss, decoder_forward,
                                          embed_tokens, init_llm_params,
                                          lm_head)
from flash_vstream_tpu.parallel.sequence import (create_sp_mesh,
                                                 ring_attention_local,
                                                 sp_decoder_forward)
from flash_vstream_tpu.parallel.sharding import create_train_mesh
from flash_vstream_tpu_torch.parallel.collectives import spawn

CFG_KW = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
              num_layers=2, num_heads=4, num_kv_heads=2,
              mrope_sections=(1, 1, 2))
CFG28_KW = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
                num_layers=28, num_heads=4, num_kv_heads=2,
                attention_bias=True, mrope_sections=(2, 1, 1))
S = 32


def _ring_inputs(seed, seg):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(2, 4, S, 16)).astype(np.float32)
               for _ in range(3))
    sg = (np.asarray([[0] * 12 + [1] * 12 + [-1] * 8] * 2, np.int32)
          if seg else None)
    return dict(kind="ring", q=q, k=k, v=v, seg=sg)


def _decoder_inputs(cfg_kw, seed, B, seg=False):
    cfg = LLMConfig(**cfg_kw)
    params = jax.tree.map(np.asarray,
                          init_llm_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, size=(B, S))
    labels = ids.copy()
    labels[:, :14] = -100              # the first shards hold few targets
    labels[0, 20:23] = -100
    pos = rng.integers(0, S, size=(3, B, S))
    sg = None
    if seg:
        sg = np.concatenate([np.zeros((B, 20), np.int32),
                             np.ones((B, 8), np.int32),
                             np.full((B, 4), -1, np.int32)], axis=1)
        labels[:, 28:] = -100
    return dict(kind="sp", cfg_kw=cfg_kw, params=params, ids=ids,
                labels=labels, positions=pos, seg=sg, n_micro=1)


RUNS = {
    2: [dict(_ring_inputs(0, False), width=2),
        dict(_ring_inputs(1, True), width=2),
        dict(_decoder_inputs(CFG_KW, 0, 2), width=2),
        dict(_decoder_inputs(CFG_KW, 1, 2, seg=True), width=2)],
    4: [dict(_ring_inputs(2, False), width=4),
        dict(_ring_inputs(3, True), width=4),
        dict(_decoder_inputs(CFG_KW, 2, 2, seg=True), width=4),
        dict(_decoder_inputs(CFG28_KW, 0, 4), width=2)],
}
CASES = [(w, i) for w in RUNS for i in range(len(RUNS[w]))]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for world, runs in RUNS.items():
        d = tmp_path_factory.mktemp(f"ring{world}")
        spawn(torch_ranks.decoder_runs, world, str(d), runs,
              init_file=str(d / "init"))
        out[world] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                      for r in range(world)]
    return out


def _jax_ring(run):
    mesh = create_sp_mesh(sp=run["width"])
    q, k, v = (jnp.asarray(run[n]) for n in ("q", "k", "v"))
    seg = None if run["seg"] is None else jnp.asarray(run["seg"])
    segs = (seg,) if seg is not None else ()

    def body(q, k, v, *s):
        return ring_attention_local(
            q, k, v, axis="sp", n_sp=run["width"], causal=True,
            q_segment_ids=s[0] if s else None,
            kv_segment_ids=s[0] if s else None)

    got = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(None, None, "sp"),) * 3
        + ((P(None, "sp"),) if segs else ()),
        out_specs=P(None, None, "sp"), check_vma=False))(q, k, v, *segs)
    full = xla_attention(q, k, v, causal=True, q_segment_ids=seg,
                         kv_segment_ids=seg)
    return np.asarray(got), np.asarray(full)


def _jax_decoder(run, dp):
    cfg = LLMConfig(**run["cfg_kw"])
    params = jax.tree.map(jnp.asarray, run["params"])
    ids, labels = jnp.asarray(run["ids"]), jnp.asarray(run["labels"])
    pos = jnp.asarray(run["positions"])
    seg = None if run["seg"] is None else jnp.asarray(run["seg"])
    mesh = (create_sp_mesh(sp=run["width"]) if dp == 1
            else create_train_mesh(dp=dp, sp=run["width"]))

    def hidden(p):
        return sp_decoder_forward(p, cfg, embed_tokens(p, ids), pos,
                                  mesh=mesh, segment_ids=seg)

    def plain_hidden(p):
        return decoder_forward(p, cfg, embed_tokens(p, ids), pos,
                               segment_ids=seg)[0]

    def loss(p, fwd):
        return cross_entropy_loss(lm_head(p, cfg, fwd(p)), labels)

    grad_fwd = hidden if cfg.num_layers <= 4 else plain_hidden
    with mesh:
        h = jax.jit(hidden)(params)
        l = float(jax.jit(lambda p: loss(p, hidden))(params))
        g = jax.jit(jax.grad(lambda p: loss(p, grad_fwd)))(params)
    plain = plain_hidden(params)
    logits = np.asarray(lm_head(params, cfg, plain), np.float64)
    return (np.asarray(h), np.asarray(plain), l, logits,
            {jax.tree_util.keystr(p): np.asarray(v)
             for p, v in jax.tree_util.tree_leaves_with_path(g)})


def _mean_of_means(logits, labels, n):
    """The shifted loss as each of n shards' own mean, averaged."""
    lab = labels[:, 1:]
    lp = logits[:, :-1] - np.log(np.exp(logits[:, :-1]).sum(-1,
                                                             keepdims=True))
    nll = -np.take_along_axis(lp, np.where(lab < 0, 0, lab)[..., None],
                              -1)[..., 0]
    nll = np.concatenate([np.where(lab >= 0, nll, 0),
                          np.zeros((lab.shape[0], 1))], axis=1)
    valid = np.concatenate([lab >= 0, np.zeros((lab.shape[0], 1), bool)], 1)
    Sl = labels.shape[1] // n
    means = [nll[:, i * Sl:(i + 1) * Sl].sum()
             / max(valid[:, i * Sl:(i + 1) * Sl].sum(), 1) for i in range(n)]
    counts = [valid[:, i * Sl:(i + 1) * Sl].sum() for i in range(n)]
    return float(np.mean(means)), counts


def _keystr(path):
    return "".join(f"['{k}']" for k in path.split("/"))


@pytest.mark.parametrize("world,i", CASES)
def test_ring_matches_jax(ranks, world, i):
    run = RUNS[world][i]
    n, dp = run["width"], world // run["width"]
    res = [ranks[world][r][i] for r in range(world)]
    if run["kind"] == "ring":
        got_jax, full = _jax_ring(run)
        valid = (np.ones(S, bool) if run["seg"] is None
                 else run["seg"][0] >= 0)
        Sl = S // n
        got = np.concatenate([x["out"] for x in sorted(
            (x for x in res if x is not None),
            key=lambda x: x["inner_rank"])], axis=2)
        for want in (got_jax, full):
            np.testing.assert_allclose(got[:, :, valid], want[:, :, valid],
                                       rtol=2e-5, atol=2e-5)
        assert got.shape[2] == n * Sl
        return
    h_jax, h_plain, l_jax, logits, g_jax = _jax_decoder(run, dp)
    valid = (True if run["seg"] is None else (run["seg"] >= 0)[..., None])
    Sl = S // n
    for x in res:
        (a, b), c = x["rows"], x["inner_rank"] * Sl
        keep = valid if run["seg"] is None else valid[a:b, c:c + Sl]
        for want in (h_jax, h_plain):
            np.testing.assert_allclose(
                np.where(keep, x["h"], 0),
                np.where(keep, want[a:b, c:c + Sl], 0), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(res[0]["loss"], l_jax, rtol=1e-5)
    wrong, counts = _mean_of_means(logits, run["labels"], n)
    assert len(set(counts)) > 1 and abs(wrong - l_jax) > 1e-5 * l_jax
    for p, g in res[0]["grads"].items():
        np.testing.assert_allclose(g, g_jax[_keystr(p)], rtol=5e-4,
                                   atol=5e-5, err_msg=p)
