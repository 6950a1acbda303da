"""GPipe across ranks (flash_vstream_tpu_torch/parallel/pipeline.py)
against the JAX pipeline on its virtual CPU mesh and the plain decoder.

The port runs in gloo ranks on the CPU, one process a stage (two spawns:
world 2 for pp 2, world 4 for pp 4 and dp 2 x pp 2), each rank its dp
share of the batch; JAX's `pipeline_decoder_forward` runs in this process
over the same pp (and dp) widths. Each case: the last stage's hidden
states against JAX's pipeline and the plain decoder within 2e-5, the loss
(the shifted cross entropy, a token mean over the global batch, labels
with ignored spans) within 1e-5 relative, and every leaf's gradient,
summed over the stages and averaged over dp, within 5e-4 relative and
5e-5 absolute of jax.grad through JAX's pipeline (test_pipeline.py's
limits). CFG is tests/test_pipeline.py's, CFG28 tests/test_pp_sp_training
.py's production layer count."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from flash_vstream_tpu.core.config import LLMConfig
from flash_vstream_tpu.models.llm import (cross_entropy_loss, decoder_forward,
                                          embed_tokens, init_llm_params,
                                          lm_head)
from flash_vstream_tpu.parallel.pipeline import (create_pp_mesh,
                                                 pipeline_decoder_forward)
from flash_vstream_tpu.parallel.sharding import create_train_mesh
from flash_vstream_tpu_torch.parallel.collectives import spawn

CFG_KW = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
              num_layers=4, num_heads=4, num_kv_heads=2)
CFG28_KW = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
                num_layers=28, num_heads=4, num_kv_heads=2,
                attention_bias=True, mrope_sections=(2, 1, 1))
B, S = 4, 16


def _inputs(cfg_kw, seed, seg=False):
    cfg = LLMConfig(**cfg_kw)
    params = jax.tree.map(np.asarray,
                          init_llm_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, size=(B, S))
    labels = rng.integers(0, cfg.vocab_size, size=(B, S))
    labels[0, 3:9] = -100                    # unequal valid counts
    labels[3, 10:] = -100
    pos = np.broadcast_to(np.arange(S)[None, None], (3, B, S)).copy()
    sg = None
    if seg:
        sg = np.concatenate([np.zeros((B, 12), np.int32),
                             np.full((B, 4), -1, np.int32)], axis=1)
        labels[:, 12:] = -100
    return dict(cfg_kw=cfg_kw, params=params, ids=ids, labels=labels,
                positions=pos, seg=sg)


RUNS = {
    2: [dict(_inputs(CFG_KW, 0), kind="pp", width=2, n_micro=1),
        dict(_inputs(CFG_KW, 0), kind="pp", width=2, n_micro=2),
        dict(_inputs(CFG_KW, 1, seg=True), kind="pp", width=2, n_micro=2)],
    4: [dict(_inputs(CFG_KW, 0), kind="pp", width=4, n_micro=1),
        dict(_inputs(CFG_KW, 0), kind="pp", width=4, n_micro=2),
        dict(_inputs(CFG_KW, 2), kind="pp", width=4, n_micro=4),
        dict(_inputs(CFG28_KW, 0), kind="pp", width=2, n_micro=1)],
}
CASES = [(w, i) for w in RUNS for i in range(len(RUNS[w]))]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for world, runs in RUNS.items():
        d = tmp_path_factory.mktemp(f"gpipe{world}")
        spawn(torch_ranks.decoder_runs, world, str(d), runs,
              init_file=str(d / "init"))
        out[world] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                      for r in range(world)]
    return out


def _jax_run(run):
    """JAX's hidden states, loss and gradients over the run's mesh (dp x pp
    where the run has dp > 1), the embeddings inside the loss."""
    cfg = LLMConfig(**run["cfg_kw"])
    params = jax.tree.map(jnp.asarray, run["params"])
    ids, labels = jnp.asarray(run["ids"]), jnp.asarray(run["labels"])
    pos = jnp.asarray(run["positions"])
    seg = None if run["seg"] is None else jnp.asarray(run["seg"])
    dp = run.get("dp", 1)
    mesh = (create_pp_mesh(pp=run["width"]) if dp == 1
            else create_train_mesh(dp=dp, pp=run["width"]))
    n_micro = run["n_micro"] * dp

    def hidden(p):
        return pipeline_decoder_forward(p, cfg, embed_tokens(p, ids), pos,
                                        mesh=mesh, n_micro=n_micro,
                                        segment_ids=seg)

    def loss(p):
        return cross_entropy_loss(lm_head(p, cfg, hidden(p)), labels)

    with mesh:
        h = jax.jit(hidden)(params)
        l, g = jax.jit(jax.value_and_grad(loss))(params)
    plain, _ = decoder_forward(params, cfg, embed_tokens(params, ids), pos,
                               segment_ids=seg)
    return (np.asarray(h), np.asarray(plain), float(l),
            {jax.tree_util.keystr(p): np.asarray(v)
             for p, v in jax.tree_util.tree_leaves_with_path(g)})


def _keystr(path):
    return "".join(f"['{k}']" for k in path.split("/"))


@pytest.mark.parametrize("world,i", CASES)
def test_pipeline_matches_jax(ranks, world, i):
    run = dict(RUNS[world][i])
    run["dp"] = world // run["width"]
    h_jax, h_plain, l_jax, g_jax = _jax_run(run)
    res = ranks[world]
    # padding rows (segment -1) attend nowhere: JAX compares the valid ones
    valid = (True if run["seg"] is None else (run["seg"] >= 0)[..., None])
    seen = 0
    for r in range(world):
        got = res[r][i]
        if got["h"] is None:
            continue
        a, b = got["rows"]
        keep = valid if run["seg"] is None else valid[a:b]
        for want in (h_jax, h_plain):
            np.testing.assert_allclose(np.where(keep, got["h"], 0),
                                       np.where(keep, want[a:b], 0),
                                       rtol=2e-5, atol=2e-5)
        seen += b - a
    assert seen == B                        # every row from a last stage
    np.testing.assert_allclose(res[0][i]["loss"], l_jax, rtol=1e-5)
    for p, g in res[0][i]["grads"].items():
        np.testing.assert_allclose(g, g_jax[_keystr(p)], rtol=5e-4,
                                   atol=5e-5, err_msg=p)
