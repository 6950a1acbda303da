"""QLoRA in the port against JAX at tiny sizes, in f32 on the CPU: `dense`
under autograd over a frozen int8 / int4 weight (gradients to x and the
adapters only, no saved [din, dout] tensor), LoRA init, views and merge over
quantized leaves, the vocab-tiled chunked loss (int8, int4, tied and plain
heads) in value and in its gradient with respect to the hidden states, and
three optimizer steps of the Trainer over an int8 and an int4 base against
the JAX Trainer on the JAX composition. Tolerances are stated per test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_vstream_tpu.core.config import LLMConfig as JaxLLMConfig
from flash_vstream_tpu.core.config import tiny_qwen_config
from flash_vstream_tpu.models import layers as jlayers
from flash_vstream_tpu.models import llm as jllm
from flash_vstream_tpu.models import vstream_qwen as jvq
from flash_vstream_tpu.models.vstream_qwen import init_qwen_params as jax_init
from flash_vstream_tpu.train import lora as jlora
from flash_vstream_tpu.weights import quantize as jq
from flash_vstream_tpu_torch.core.config import LLMConfig
from flash_vstream_tpu_torch.models import layers as tlayers
from flash_vstream_tpu_torch.models import llm as tllm
from flash_vstream_tpu_torch.preprocess.image import qwen_preprocess
from flash_vstream_tpu_torch.preprocess.qwen_processor import (
    make_byte_qwen_tokenizer)
from flash_vstream_tpu_torch.train import finetune_flash as tft
from flash_vstream_tpu_torch.train import lora as tlora
from flash_vstream_tpu_torch.train import trainer as ttrainer
from flash_vstream_tpu_torch.weights import quantize as tq
from flash_vstream_tpu_torch.weights.from_jax import (lora_from_numpy,
                                                      params_from_numpy)

torch.set_num_threads(1)
RANK, ALPHA = 4, 8.0
QUANT = {8: (jq.quantize_params, tq.quantize_params),
         4: (jq.quantize_params4, tq.quantize_params4)}


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(torch.as_tensor(got).detach().float().numpy(),
                               want, atol=rel * scale, err_msg=what)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_qwen_config()
    jparams = jax_init(jax.random.PRNGKey(0), cfg)
    return cfg, jparams, params_from_numpy(_np(jparams), "cpu")


def _adapters(jparams, seed):
    """The JAX init's adapters over `jparams` with b != 0 (so `a` has a
    gradient)."""
    jl = jlora.init_lora_params(jax.random.PRNGKey(seed), jparams, rank=RANK,
                                targets=jlora.QWEN_TARGETS)
    rng = np.random.default_rng(seed)
    return {p: {"a": ab["a"],
                "b": jnp.asarray(0.1 * rng.normal(size=ab["b"].shape),
                                 jnp.float32)}
            for p, ab in jl.items()}


@pytest.mark.parametrize("bits", [8, 4])
def test_dense_grad_saves_no_dequantized_weight(bits):
    """x @ a frozen quantized [64, 96] weight inside a LoRA view: the
    gradients of x, a and b equal JAX's (1e-5 x max), the base gets none,
    and no tensor saved for the backward has the weight's [64, 96] shape.
    The check is shown to catch the copy: autograd of the dequantize path
    (what `dense` would do without its Function) saves one."""
    rng = np.random.default_rng(bits)
    w = rng.normal(size=(64, 96)).astype(np.float32)
    a = (0.1 * rng.normal(size=(64, 4))).astype(np.float32)
    b = (0.1 * rng.normal(size=(4, 96))).astype(np.float32)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    jw = (jq.quantize_weight if bits == 8 else jq.quantize_weight4)(
        jnp.asarray(w))
    tw = (tq.quantize_weight if bits == 8 else tq.quantize_weight4)(
        torch.from_numpy(w))

    def jloss(x, a, b):
        return jnp.sum(jlayers.dense(x, jlora.LoRAWeight(jw, a, b)) ** 2)
    want = jax.grad(jloss, argnums=(0, 1, 2))(x, a, b)
    tx, ta, tb = (torch.from_numpy(v).requires_grad_() for v in (x, a, b))
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tlayers.dense(tx, tlora.LoRAWeight(tw, ta, tb))
    (out ** 2).sum().backward()
    for got, w_, name in zip((tx, ta, tb), want, "xab"):
        _close(got.grad, w_, 1e-5, name)
    assert saved and (64, 96) not in saved, saved
    assert all(not f.requires_grad and f.grad is None for f in tw)
    naive = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: naive.append(tuple(t.shape)) or t, lambda t: t):
        tlayers._quant_matmul(tx, tw)
    assert (64, 96) in naive


@pytest.mark.parametrize("bits", [8, 4])
def test_lora_over_quantized_leaves(tiny, bits):
    """init over a quantized tree adapts the same paths with the logical
    [din, dout] shapes JAX reads (`_weight_shape`: int4 packs input pairs);
    a view wraps the quantized leaf untouched; `merge_lora` dequantizes an
    adapted leaf to the adapters' f32 and merges (1e-6 x max) and leaves
    the others quantized."""
    cfg, jparams, tparams = tiny
    jbase = QUANT[bits][0](jparams)
    tbase = QUANT[bits][1](tparams)
    jl = _adapters(jbase, 3)
    init = tlora.init_lora_params(torch.Generator().manual_seed(0), tbase,
                                  rank=RANK, targets=tlora.QWEN_TARGETS)
    assert sorted(init) == sorted(jl)
    for p, ab in init.items():
        for k in ("a", "b"):
            assert tuple(ab[k].shape) == jl[p][k].shape, (p, k)
        assert not ab["b"].any()
    tl = lora_from_numpy(_np(jl), "cpu")
    view = tlora.lora_views(tbase, tl, ALPHA, RANK)
    wq = view["llm"]["layers"]["attn"]["wq"]["w"]
    assert isinstance(wq, tlora.LoRAWeight) and type(wq.w) is type(
        tbase["llm"]["layers"]["attn"]["wq"]["w"])
    want = jlora.merge_lora(jbase, jl, ALPHA, RANK)
    got = tlora.merge_lora_into_weights(tbase, tl, ALPHA, RANK)
    for p in jl:
        _close(_leaf(got, p), _leaf(want, p), 1e-6, p)
        assert _leaf(got, p).dtype == torch.float32
    head = got["llm"]["lm_head"]
    assert isinstance(head, tq.QuantWeight if bits == 8 else tq.QuantWeight4)


@pytest.mark.parametrize("head", ["int8", "int4", "tied", "plain"])
def test_vocab_tiled_loss_matches_jax(head):
    """cross_entropy_loss_chunked over vocab 1,000 in tiles of 250 (the
    largest divisor <= 256) and chunks of 5 over 13 shifted tokens (a short
    last chunk, two ignored labels, labels in every tile): the loss and its
    gradient with respect to the hidden states against JAX's (1e-5 relative,
    1e-5 x max). A quantized head tiles by default; here every kind is
    asked for tiles of 256."""
    kw = dict(vocab_size=1000, hidden_size=32, intermediate_size=64,
              num_layers=1, num_heads=2, num_kv_heads=1,
              tie_word_embeddings=head == "tied")
    jcfg, tcfg = JaxLLMConfig(**kw), LLMConfig(**kw)
    params = jllm.init_llm_params(jax.random.PRNGKey(2), jcfg)
    params = {"int8": jq.quantize_params, "int4": jq.quantize_params4}.get(
        head, lambda p: p)(params)
    assert ("lm_head" in params) == (head != "tied")
    rng = np.random.default_rng(1)
    h = rng.normal(size=(1, 14, 32)).astype(np.float32)
    lab = rng.integers(0, 1000, (1, 14))
    lab[0, [2, 9]] = -100

    def jloss(hh):
        return jllm.cross_entropy_loss_chunked(params, jcfg, hh,
                                               jnp.asarray(lab), chunk=5,
                                               vocab_tile=256)
    want, jg = jax.value_and_grad(jloss)(jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_()
    got = tllm.cross_entropy_loss_chunked(
        params_from_numpy(_np(params), "cpu"), tcfg, th,
        torch.from_numpy(lab), chunk=5, vocab_tile=256)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _close(th.grad, jg, 1e-5)
    full = jllm.cross_entropy_loss(jllm.lm_head(params, jcfg, jnp.asarray(h)),
                                   jnp.asarray(lab))
    np.testing.assert_allclose(got.item(), float(full), rtol=1e-5)
    if head in ("int8", "int4"):          # tiles of 8,192: one here
        assert tllm._largest_divisor_le(1000, 8192) == 1000


def _scene_sample(cfg, max_len):
    """12 frame pairs in 4 scenes (k-means into the 4 CSM clusters and DAM
    retrieval both run; test_torch_train.py's `_scenes`)."""
    rng = np.random.default_rng(1)
    frames = []
    for i, size in enumerate((5, 4, 2, 1)):
        texture = rng.integers(0, 256, (56, 56, 3))
        for j in range(size):
            f = texture + (rng.integers(-24, 25, texture.shape) if j else 0)
            frames += [f.clip(0, 255).astype(np.uint8)] * 2
    patches, grid = qwen_preprocess(frames)
    item = {"conversations": [
        {"from": "human", "value": "<video>\nDescribe it."},
        {"from": "gpt", "value": "Noise, mostly."}]}
    ids, labels, span = tft.preprocess_qwen_sample(
        item, make_byte_qwen_tokenizer(), cfg, grid, max_len)
    pad = max_len - len(ids)
    seg = np.concatenate([np.zeros(len(ids), np.int32),
                          np.full(pad, -1, np.int32)])
    return (patches, grid, np.pad(ids, (0, pad)),
            np.pad(labels, (0, pad), constant_values=-100), span, seg)


@pytest.mark.parametrize("bits", [8, 4])
def test_qlora_trainer_steps_match_jax(tiny, bits):
    """LoRA over a frozen int8 or int4 base (the whole tree quantized, as
    --int8-base does). First one video sample's `sample_loss` (the ViT over
    the quantized blocks, k-means seeded with the same draws, the merger,
    the decoder, the loss) against the JAX composition: within 1e-4
    relative. Then three optimizer steps (the first at lr 0) of the port's
    Trainer against the JAX Trainer, the loss the decoder's over the JAX
    encode's visual embeddings (the bf16 merger's output differs between
    the frameworks by an ulp here and there, which reaches every decoder
    gradient; on equal embeddings the adapter gradients agree to 1e-5):
    losses within 1e-5 relative, the final adapters within 1e-4 x max in
    99% of their elements (an element whose gradient is bf16 rounding
    noise may step either way, as in test_run_training_matches_jax)."""
    from flash_vstream_tpu.parallel.sharding import create_mesh
    from flash_vstream_tpu.train.trainer import TrainConfig as JCfg
    from flash_vstream_tpu.train.trainer import Trainer as JTrainer
    from flash_vstream_tpu_torch.models import vstream_qwen as tvq
    cfg, jparams, tparams = tiny
    jbase, tbase = QUANT[bits][0](jparams), QUANT[bits][1](tparams)
    max_len = 160
    patches, grid, ids, labels, (start, n_vis), seg = _scene_sample(
        cfg, max_len)
    key = jax.random.PRNGKey(7)
    draws = lambda n: torch.from_numpy(np.array(jax.random.uniform(
        key, (n,))))
    jl = _adapters(jbase, 5)

    def jviews(lora_params, base):
        lp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), lora_params)
        return jlora.lora_views(base, lp, alpha=ALPHA, rank=RANK)

    def jdecoder_loss(eff, vemb, vpos):
        positions, _ = jvq.build_qwen_positions_dynamic(
            max_len, jnp.int32(start), n_vis, vpos)
        embeds = jllm.embed_tokens(eff["llm"], jnp.asarray(ids)[None])
        embeds = jvq.splice_embeds_dynamic(embeds, vemb, jnp.int32(start))
        h, _ = jllm.decoder_forward(eff["llm"], cfg.llm, embeds, positions,
                                    segment_ids=jnp.asarray(seg)[None],
                                    remat=True)
        return jllm.cross_entropy_loss(jllm.lm_head(eff["llm"], cfg.llm, h),
                                       jnp.asarray(labels)[None])

    eff = jviews(jl, jbase)
    vis = jvq.encode_video(eff, cfg, jnp.asarray(patches), grid, key=key,
                           vit_chunk=4, vit_remat=True)
    want = jdecoder_loss(eff, vis.video_embeds, vis.visual_positions)
    got = tft.sample_loss(cfg, tbase, lora_from_numpy(_np(jl), "cpu"),
                          torch.from_numpy(patches), grid,
                          torch.from_numpy(ids), torch.from_numpy(labels),
                          torch.from_numpy(seg), start, n_vis, draws,
                          alpha=ALPHA, rank=RANK, vit_chunk=4)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)

    vemb = np.asarray(vis.video_embeds, np.float32)
    vpos = np.asarray(vis.visual_positions)
    dl = {p: ab for p, ab in jl.items() if p.startswith("llm/")}

    def jloss(lora_params, batch, _key, base):
        return jdecoder_loss(jviews(lora_params, base), jnp.asarray(vemb),
                             jnp.asarray(vpos))

    def tloss(lora_params, batch, _key, base):
        lp = {p: {k: v.to(torch.bfloat16) for k, v in ab.items()}
              for p, ab in lora_params.items()}
        eff = tlora.lora_views(base, lp, alpha=ALPHA, rank=RANK)
        positions, _ = tvq.build_qwen_positions_dynamic(
            max_len, start, n_vis, torch.from_numpy(vpos.copy()))
        embeds = tllm.embed_tokens(eff["llm"], torch.from_numpy(ids)[None])
        embeds = tvq.splice_embeds_dynamic(embeds, torch.from_numpy(vemb),
                                           start)
        h = tllm.decoder_forward(eff["llm"], cfg.llm, embeds, positions,
                                 segment_ids=torch.from_numpy(seg)[None],
                                 remat=True)
        return tllm.cross_entropy_loss(tllm.lm_head(eff["llm"], cfg.llm, h),
                                       torch.from_numpy(labels)[None])

    kw = dict(learning_rate=5e-3, total_steps=3, grad_accum=1)
    jt = JTrainer(jloss, dl, JCfg(**kw), mesh=create_mesh(dp=1, tp=1),
                  frozen=jbase)
    tt = ttrainer.Trainer(tloss, lora_from_numpy(_np(dl), "cpu"),
                          ttrainer.TrainConfig(**kw), frozen=tbase)
    batch = {"i": np.zeros((1, 1), np.float32)}
    for s in range(3):
        want = jt.run_step(jax.tree.map(jnp.asarray, batch),
                           jax.random.PRNGKey(s))
        got = tt.run_step(batch, s)
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=str(s))
    moved = 0
    for p, ab in tt.params.items():
        for k, x in ab.items():
            w = np.asarray(jt.params[p][k])
            near = np.abs(x.detach().numpy() - w) <= 1e-4 * np.abs(w).max()
            assert near.mean() >= 0.99, f"{p}/{k}: {near.mean()}"
            moved += int(not np.array_equal(x.detach().numpy(),
                                            np.asarray(dl[p][k])))
    assert moved == 2 * len(dl)
