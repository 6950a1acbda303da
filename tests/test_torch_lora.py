"""LoRA and the training losses of the port against JAX at the tiny config,
in f32 on the CPU: adapter target selection, `dense` on a LoRA view,
`merge_lora`, the two cross-entropy losses (with padding and ignore_index),
and `decoder_forward` under checkpointing (equal gradients with remat off,
per layer and per group). Tolerances: 1e-5 x max for single ops, 1e-4 x max
for the two-layer decoder's values and gradients (f32 matmuls summed in
another order). Adapters carry b != 0, so `a` has a gradient."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_vstream_tpu.core.config import tiny_qwen_config
from flash_vstream_tpu.models import layers as jlayers
from flash_vstream_tpu.models import llm as jllm
from flash_vstream_tpu.models.vstream_qwen import init_qwen_params as jax_init
from flash_vstream_tpu.train import lora as jlora
from flash_vstream_tpu_torch.models import layers as tlayers
from flash_vstream_tpu_torch.models import llm as tllm
from flash_vstream_tpu_torch.train import lora as tlora
from flash_vstream_tpu_torch.weights.from_jax import (lora_from_numpy,
                                                      params_from_numpy)

torch.set_num_threads(1)
RANK, ALPHA = 4, 8.0


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(torch.as_tensor(got).detach().float().numpy(),
                               want, atol=rel * scale, err_msg=what)


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_qwen_config()
    jparams = jax_init(jax.random.PRNGKey(0), cfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jl = jlora.init_lora_params(jax.random.PRNGKey(1), jparams, rank=RANK,
                                targets=jlora.QWEN_TARGETS)
    rng = np.random.default_rng(0)
    jl = {p: {"a": ab["a"],
              "b": jnp.asarray(0.1 * rng.normal(size=ab["b"].shape),
                               jnp.float32)}
          for p, ab in jl.items()}
    tl = lora_from_numpy(jax.tree.map(np.asarray, jl), "cpu")
    return cfg, jparams, tparams, jl, tl


def test_init_lora_params_targets(tiny):
    """The same adapted paths and shapes as JAX (the decoder's seven
    projections and the merger's two, never the ViT blocks); b = 0 and a
    ~ N(0, 1/r)."""
    cfg, jparams, tparams, jl, _ = tiny
    got = tlora.init_lora_params(torch.Generator().manual_seed(0), tparams,
                                 rank=RANK, targets=tlora.QWEN_TARGETS)
    assert sorted(got) == sorted(jl)
    assert len(got) == 9 and not any(p.startswith("vit/layers") for p in got)
    for p, ab in got.items():
        assert tuple(ab["a"].shape) == jl[p]["a"].shape
        assert tuple(ab["b"].shape) == jl[p]["b"].shape
        assert not ab["b"].any()
    a = torch.cat([ab["a"].flatten() for ab in got.values()])
    assert abs(a.std().item() * np.sqrt(RANK) - 1.0) < 0.05
    dflt = tlora.init_lora_params(torch.Generator().manual_seed(0), tparams,
                                  rank=RANK)
    assert sorted(dflt) == [p for p in sorted(jl) if p.startswith("llm/")]
    assert tlora.is_lora_target("layers/attn/wq/w", tlora.DEFAULT_TARGETS)
    assert not tlora.is_lora_target("vit/layers/attn/wq/w",
                                    tlora.DEFAULT_TARGETS)


def test_dense_on_lora_view_and_merge(tiny):
    """`dense` on a LoRA view (layer 0 of a stacked leaf, and the merger's
    unstacked fc1) equals the JAX dense, and equals dense on the merged
    weight; merge_lora equals the JAX merge."""
    cfg, jparams, tparams, jl, tl = tiny
    jv = jlora.lora_views(jparams, jl, ALPHA, RANK)
    tv = tlora.lora_views(tparams, tl, ALPHA, RANK)
    jm = jlora.merge_lora(jparams, jl, ALPHA, RANK)
    tm = tlora.merge_lora(tparams, tl, ALPHA, RANK)
    rng = np.random.default_rng(1)
    for path in ("llm/layers/attn/wq/w", "llm/layers/mlp/down/w",
                 "vit/merger/fc1/w"):
        jw, tw = _leaf(jv, path), _leaf(tv, path)
        assert isinstance(tw, tlora.LoRAWeight)
        if path.startswith("llm/layers"):
            jw = jax.tree.map(lambda t: t[0], jw)
            tw = tlayers.layer_slice({"w": tw}, 0)["w"]
        x = rng.normal(size=(3, tw.w.shape[0])).astype(np.float32)
        want = jlayers.dense(jnp.asarray(x), jw)
        got = tlayers.dense(torch.from_numpy(x), tw)
        _close(got, want, 1e-5, path)
        merged = _leaf(tm, path)
        if path.startswith("llm/layers"):
            merged = merged[0]
        _close(tlayers.dense(torch.from_numpy(x), merged), want, 1e-5, path)
    for path in tl:
        _close(_leaf(tm, path), _leaf(jm, path), 1e-5, path)
    # leaves not adapted stay the base's tensors
    assert _leaf(tm, "llm/embed") is _leaf(tparams, "llm/embed")


def test_lora_views_never_grad_the_base(tiny):
    _, _, tparams, _, tl = tiny
    base = {"w": tparams["llm"]["layers"]["attn"]["wq"]["w"][0]
            .clone().requires_grad_()}
    ab = {k: v[0].clone().requires_grad_() for k, v in
          tl["llm/layers/attn/wq/w"].items()}
    view = tlora.lora_views(base, {"w": ab}, ALPHA, RANK)["w"]
    out = tlayers.dense(torch.ones(2, base["w"].shape[0]), view).sum()
    out.backward()
    assert base["w"].grad is None
    assert ab["a"].grad is not None and ab["b"].grad is not None


def _labels(rng, B, S, V, n_ignore):
    labels = rng.integers(0, V, size=(B, S))
    labels[:, :n_ignore] = -100                         # prompt
    labels[:, -5:] = -100                               # padding
    return labels.astype(np.int64)


def test_cross_entropy_loss(tiny):
    V = tiny[0].llm.vocab_size
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 12, V)).astype(np.float32)
    labels = _labels(rng, 2, 12, V, 3)
    want, jg = jax.value_and_grad(jllm.cross_entropy_loss)(
        jnp.asarray(logits), jnp.asarray(labels))
    t = torch.from_numpy(logits).requires_grad_()
    got = tllm.cross_entropy_loss(t, torch.from_numpy(labels))
    got.backward()
    _close(got, want, 1e-6)
    _close(t.grad, jg, 1e-5)


@pytest.mark.parametrize("chunk", [8, 36, 64])
def test_cross_entropy_loss_chunked(tiny, chunk):
    """Chunks that do not divide S - 1 (8), that cover it (36), and wider
    than it; value and gradient wrt the hidden states against JAX and
    against the unchunked loss."""
    cfg, jparams, tparams, _, _ = tiny
    rng = np.random.default_rng(3)
    S = 37
    hidden = rng.normal(size=(1, S, cfg.llm.hidden_size)).astype(np.float32)
    labels = _labels(rng, 1, S, cfg.llm.vocab_size, 9)

    def jloss(h):
        return jllm.cross_entropy_loss_chunked(jparams["llm"], cfg.llm, h,
                                               jnp.asarray(labels),
                                               chunk=chunk)
    want, jg = jax.value_and_grad(jloss)(jnp.asarray(hidden))
    h = torch.from_numpy(hidden).requires_grad_()
    got = tllm.cross_entropy_loss_chunked(tparams["llm"], cfg.llm, h,
                                          torch.from_numpy(labels),
                                          chunk=chunk)
    (g,) = torch.autograd.grad(got, h)
    _close(got, want, 1e-6)
    _close(g, jg, 1e-5)
    full = tllm.cross_entropy_loss(tllm.lm_head(tparams["llm"], cfg.llm, h),
                                   torch.from_numpy(labels))
    _close(got, full.detach(), 1e-6)


def _decoder_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    S = 24
    embeds = rng.normal(size=(1, S, cfg.hidden_size)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, 1, S)).copy()
    pos[:, 0, 4:12] = np.stack([np.repeat([0, 1], 4),
                                np.tile(np.repeat([0, 1], 2), 2),
                                np.tile([0, 1], 4)]) + 4
    pos[:, 0, 12:] = 6 + np.arange(S - 12)
    seg = np.zeros((1, S), np.int32)
    seg[:, -4:] = -1
    r = rng.normal(size=(1, S, cfg.hidden_size)).astype(np.float32)
    return embeds, pos, seg, r


def test_decoder_forward_remat_grads(tiny):
    """Adapter gradients of sum(r * decoder_forward(...)) over LoRA views:
    remat off, per layer and per group of 2 agree to 1e-6 x max with each
    other, and to 1e-4 x max with jax.grad of the JAX decoder with remat."""
    cfg, jparams, tparams, jl, tl = tiny
    llm_l = {p[len("llm/"):]: ab for p, ab in jl.items()
             if p.startswith("llm/")}
    embeds, pos, seg, r = _decoder_inputs(cfg.llm, 4)

    def jloss(lp):
        eff = jlora.lora_views(jparams["llm"], lp, ALPHA, RANK)
        h, _ = jllm.decoder_forward(eff, cfg.llm, jnp.asarray(embeds),
                                    jnp.asarray(pos),
                                    segment_ids=jnp.asarray(seg), remat=True,
                                    remat_group=2)
        return jnp.sum(h * r)
    jval, jg = jax.value_and_grad(jloss)(llm_l)

    results = []
    for remat, group in ((False, 1), (True, 1), (True, 2)):
        lp = {p[len("llm/"):]: {k: v.clone().requires_grad_()
                                for k, v in ab.items()}
              for p, ab in tl.items() if p.startswith("llm/")}
        eff = tlora.lora_views(tparams["llm"], lp, ALPHA, RANK)
        h = tllm.decoder_forward(eff, cfg.llm, torch.from_numpy(embeds),
                                 torch.from_numpy(pos),
                                 segment_ids=torch.from_numpy(seg),
                                 remat=remat, remat_group=group)
        val = (h * torch.from_numpy(r)).sum()
        leaves = [(p, k, x) for p, ab in sorted(lp.items())
                  for k, x in sorted(ab.items())]
        grads = torch.autograd.grad(val, [x for *_, x in leaves])
        results.append((val, {(p, k): g for (p, k, _), g in
                              zip(leaves, grads)}))
    for val, grads in results:
        _close(val, jval, 1e-4)
        for (p, k), g in grads.items():
            _close(g, jg[p][k], 1e-4, f"{p}/{k}")
            _close(g, results[0][1][(p, k)], 1e-6, f"{p}/{k} remat")
