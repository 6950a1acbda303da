"""The LLaVA family's training path of the port against JAX at the tiny
LLaVA config on the CPU, in f32 (one update test in bf16):
`llava_forward_train`'s logits, the three modality losses of `run_training` (video over features and over raw
frames, image, text) with their gradients against jax.value_and_grad, one
`Trainer` step of each stage against the JAX Trainer, a `run_training
--dry-run` against the JAX run (its dataset and its draws carried across)
at each stage with a resume, the raw-media dry run, and the trainer's
repairs (frozen leaves get no gradient and no moment; the update taken in
slices equals the whole; a bf16 update equals optax's bit for bit).
Inputs come from numpy seeds; the STAR draws are JAX's uniforms.
Tolerances are stated per test, and the planted faults (labels shifted by
one, the NTM's parameters detached in the port's loss, a slice left out of
the update, a pre segment padded on the wrong side, in
tests/test_torch_llava_data.py) are shown to fail them."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_vstream_tpu.core.config import tiny_llava_config
from flash_vstream_tpu.models import llm as jllm
from flash_vstream_tpu.models import vstream_llava as jvl
from flash_vstream_tpu.models.projector import project as jproject
from flash_vstream_tpu.ops.pooling import merge_2x2_tokens as jmerge
from flash_vstream_tpu.parallel.sharding import create_mesh
from flash_vstream_tpu.preprocess.image import (
    clip_device_preprocess as jclip_pre)
from flash_vstream_tpu.preprocess.tokenizer import ByteTokenizer as JByte
from flash_vstream_tpu.train import recipes as jrecipes
from flash_vstream_tpu.train import train as jtrain
from flash_vstream_tpu.train.trainer import Trainer as JTrainer
from flash_vstream_tpu_torch.models import vstream_llava as tvl
from flash_vstream_tpu_torch.preprocess.tokenizer import ByteTokenizer
from flash_vstream_tpu_torch.train import data as tdata
from flash_vstream_tpu_torch.train import recipes as trecipes
from flash_vstream_tpu_torch.train import train as ttrain
from flash_vstream_tpu_torch.train import trainer as ttrainer
from flash_vstream_tpu_torch.train.checkpoint import latest_checkpoint
from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy

torch.set_num_threads(1)
PRE, POST, BUCKET = 24, 48, 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _err(got, want):
    """max |got - want| over max |want|."""
    want = np.asarray(want, np.float32)
    got = torch.as_tensor(got).detach().float().numpy()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_llava_config()
    jparams = jvl.init_llava_params(jax.random.PRNGKey(0), cfg)
    return cfg, jparams, params_from_numpy(_np(jparams), "cpu")


def _scene_feats(rng, n_frames, T, P=64, D=32, n_scenes=4):
    """[T, P, D] features of n_frames frames in consecutive scenes (a
    center each plus small noise; zeros past n_frames): k-means and the
    key-frame retrieval decide by margins far above rounding."""
    centers = rng.normal(size=(n_scenes, P, D)) * 3
    # scenes of 1, 1, 1 and the rest of the frames: no cluster of exactly
    # two frames, whose centroid ties the retrieval between them
    scene = np.minimum(np.arange(n_frames), n_scenes - 1)
    x = np.zeros((T, P, D), np.float32)
    x[:n_frames] = centers[scene] + 0.1 * rng.normal(size=(n_frames, P, D))
    return x


def _video_batch(cfg, tok, stage, n_frames=(8, 5), seed=0, frames=False):
    """One collated video micro-batch of len(n_frames) samples (features,
    or uint8 frames in scenes with frames=True), in run_training's layout."""
    rng = np.random.default_rng(seed)
    samples = []
    for i, n in enumerate(n_frames):
        conv = [{"from": "human", "value": "<image>\n" + "Why? " * (i + 1)},
                {"from": "gpt", "value": f"Because {i} " * (2 + i)}]
        if stage == "pretrain":
            ids, labels = tdata.preprocess_plain(conv, tok)
        else:
            ids, labels = tdata.preprocess_v1(conv, tok)
        s = {"input_ids": ids, "labels": labels, "n_frames": n}
        if frames:
            side = cfg.vit.image_size
            tex = rng.integers(0, 256, (3, side, side, 3))
            idx = np.sort(rng.integers(0, 3, n))
            s["frames"] = [np.clip(tex[j] + rng.integers(-8, 9, tex[j].shape),
                                   0, 255).astype(np.uint8) for j in idx]
        else:
            s["features"] = _scene_feats(rng, n, n)
        samples.append(s)
    b = tdata.collate_llava(samples, BUCKET, tok.pad_token_id,
                            fixed_pre_len=PRE, fixed_post_len=POST)
    n_mem = sum(tvl.star_valid_counts(cfg, BUCKET))
    out = {"input_ids": b["input_ids"],
           "labels": tdata.spliced_labels(b, n_mem),
           "segments": tdata.spliced_segments(b, n_mem, tok.pad_token_id),
           "n_frames": b["n_frames"]}
    if frames:
        out["frames"] = b["frames"]
    else:
        out["images"] = b["features"]
    return out, n_mem


def _jax_draw_keys(step, B):
    _, sub = jax.random.split(jax.random.PRNGKey(step))
    return jax.random.split(sub, B)


def _port_draws(step, micro, sample, n, B=2):
    return torch.from_numpy(np.array(jax.random.uniform(
        _jax_draw_keys(step, B)[sample], (n,))))


def _jax_losses(cfg, n_mem, n_img):
    """JAX run_training's video_loss / image_loss / text_loss
    (flash_vstream_tpu/train/train.py:179-230), with its key handling."""
    image_slot = PRE

    def decode_loss(params, embeds, segments, labels):
        B, S = embeds.shape[:2]
        pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
        h, _ = jllm.decoder_forward(params["llm"], cfg.llm, embeds, pos,
                                    segment_ids=segments, remat=True)
        return jllm.cross_entropy_loss(jllm.lm_head(params["llm"], cfg.llm,
                                                    h), labels)

    def splice(params, ids, visual):
        ids = jnp.maximum(ids, 0)
        return jnp.concatenate([
            jllm.embed_tokens(params["llm"], ids[:, :image_slot]),
            visual.astype(params["llm"]["embed"].dtype),
            jllm.embed_tokens(params["llm"], ids[:, image_slot + 1:])], 1)

    def video_loss(params, batch, key):
        if "frames" in batch:
            B, T = batch["frames"].shape[:2]
            flat = batch["frames"].reshape(B * T, *batch["frames"].shape[2:])
            feats = jvl.encode_frames(params, cfg, jclip_pre(flat))
            feats = feats.reshape(B, T, *feats.shape[1:])
        else:
            feats = batch["images"]

        def one(feat, n, k):
            mem = jvl.consolidate(params, cfg, feat, n, k)
            return jvl.pack_memory_tokens(mem, n_mem)
        mems = jax.vmap(one)(feats, batch["n_frames"],
                             jax.random.split(key, feats.shape[0]))
        proj = jproject(params["projector"], cfg.projector, mems)
        return decode_loss(params, splice(params, batch["input_ids"], proj),
                           batch["segments"], batch["labels"])

    def image_loss(params, batch, key):
        from flash_vstream_tpu.models.clip_vit import clip_encode
        feats = clip_encode(params["vit"], cfg.vit, jclip_pre(batch["image"]))
        if cfg.projector.use_4_vision_tokens:
            feats = jmerge(feats)
        proj = jproject(params["projector"], cfg.projector, feats)
        return decode_loss(params, splice(params, batch["input_ids"], proj),
                           batch["segments"], batch["labels"])

    def text_loss(params, batch, key):
        embeds = jllm.embed_tokens(params["llm"],
                                   jnp.maximum(batch["input_ids"], 0))
        return decode_loss(params, embeds, batch["segments"],
                           batch["labels"])

    return {"video": video_loss, "image": image_loss, "text": text_loss}


def _leaves(tree):
    return dict(ttrainer.tree_leaves_with_path(tree))


def _jleaves(tree):
    from flash_vstream_tpu.parallel.sharding import path_str
    return {path_str(p): x
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _grad_misses(leaves, grads, jgl):
    """Trained leaves whose gradient is not within 1e-4 of the max of
    JAX's or, for a leaf whose true gradient is zero or sits at f32 noise,
    within the smaller of 1e-6 of the largest gradient and 1e-3 of the
    largest in its part (`llm`, `projector`, `ntm`): the NTM's gradients
    read about 1e-8 beside the decoder's 1e-1, their noise up to 4.6e-4
    of a leaf's max (`ntm/.bq`), and its key bias's is zero in exact
    arithmetic. A gradient of None counts as zeros."""
    top = max(float(np.abs(jgl[p]).max()) for p in leaves)
    part = {}
    for p in leaves:
        k = p.split("/")[0]
        part[k] = max(part.get(k, 0.0), float(np.abs(jgl[p]).max()))
    misses = set()
    for (p, x), g in zip(leaves.items(), grads):
        g = torch.zeros_like(x) if g is None else g
        diff = float((g - torch.from_numpy(np.asarray(jgl[p]))).abs().max())
        floor = min(1e-6 * top, 1e-3 * part[p.split("/")[0]])
        if diff > max(1e-4 * float(np.abs(jgl[p]).max()), floor):
            misses.add(p)
    return misses


def _ntm_detached(params):
    """`params` with the NTM's parameters cut from the graph (a fault)."""
    ntm = params["ntm"]
    return dict(params, ntm=type(ntm)(*(x.detach() for x in ntm)))


def test_forward_train_logits(tiny):
    """`llava_forward_train` over raw frames (B 2, a bucket of 8 frames, one
    video of 5: its memory splices invalid rows, as JAX's) against JAX's:
    logits within 1e-4 of max (CLIP, k-means and the decoder in f32)."""
    cfg, jparams, tparams = tiny
    tok = ByteTokenizer()
    batch, n_mem = _video_batch(cfg, tok, "finetune", frames=True)
    images = jclip_pre(jnp.asarray(batch["frames"].reshape(
        -1, *batch["frames"].shape[2:]))).reshape(
        *batch["frames"].shape[:2], 3, cfg.vit.image_size, cfg.vit.image_size)
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda p, i, n, ids, seg: jvl.llava_forward_train(
        p, cfg, i, n, ids, PRE, n_mem, None, segment_ids=seg, key=key))(
        jparams, images, jnp.asarray(batch["n_frames"]),
        jnp.asarray(batch["input_ids"]), jnp.asarray(batch["segments"]))
    keys = jax.random.split(key, 2)
    got = tvl.llava_forward_train(
        tparams, cfg, torch.from_numpy(np.asarray(images)),
        batch["n_frames"], torch.from_numpy(batch["input_ids"]), PRE, n_mem,
        segment_ids=torch.from_numpy(batch["segments"]),
        draws=lambda b, n: torch.from_numpy(np.array(
            jax.random.uniform(keys[b], (n,)))))
    assert got.shape == want.shape == (2, PRE + n_mem + POST,
                                       cfg.llm.vocab_size)
    assert _err(got, want) < 1e-4


@pytest.mark.parametrize("modality", ["features", "frames", "image", "text"])
def test_modality_losses_and_grads(tiny, modality):
    """run_training's losses at the finetune stage (every leaf but the
    tower trains) against jax.value_and_grad of JAX's: the loss within 1e-5
    relative, every trained leaf's gradient within 1e-4 of its max (f32
    throughout; a leaf whose true gradient is zero or at f32 noise within
    `_grad_misses`'s floor), the NTM's
    gradient nonzero over features (with one valid key a chunk, as in the
    raw-frame case, the NTM's softmax is 1 and its gradient 0)."""
    cfg, jparams, tparams = tiny
    tok = ByteTokenizer()
    grid = cfg.vit.image_size // cfg.vit.patch_size
    n_img = grid * grid
    if modality in ("features", "frames"):
        # raw frames: 4 and 2 history frames pass through the long memory
        # (k-means over CLIP features of random textures would decide by
        # rounding; the features case runs it)
        batch, n_mem = _video_batch(
            cfg, tok, "finetune", frames=modality == "frames",
            n_frames=(5, 3) if modality == "frames" else (8, 5))
        kind = "video"
    elif modality == "image":
        rng = np.random.default_rng(1)
        side = cfg.vit.image_size
        samples = []
        for i in range(2):
            ids, labels = tdata.preprocess_v1(
                [{"from": "human", "value": "<image>\nDescribe."},
                 {"from": "gpt", "value": f"A pattern {i}."}], tok)
            samples.append({"input_ids": ids, "labels": labels,
                            "image_frame": rng.integers(
                                0, 256, (side, side, 3), dtype=np.uint8)})
        b = tdata.collate_llava(samples, BUCKET, tok.pad_token_id,
                                fixed_pre_len=PRE, fixed_post_len=POST)
        n_mem = sum(tvl.star_valid_counts(cfg, BUCKET))
        batch = {"input_ids": b["input_ids"], "image": b["image"],
                 "labels": tdata.spliced_labels(b, n_img),
                 "segments": tdata.spliced_segments(b, n_img,
                                                    tok.pad_token_id)}
        kind = "image"
    else:
        samples = []
        for i in range(2):
            ids, labels = tdata.preprocess_v1(
                [{"from": "human", "value": f"Say {i}."},
                 {"from": "gpt", "value": f"It is {i}."}], tok,
                has_image=False)
            samples.append({"input_ids": ids, "labels": labels})
        batch = tdata.collate_text(samples, tok.pad_token_id, 64)
        n_mem = sum(tvl.star_valid_counts(cfg, BUCKET))
        kind = "text"
    jloss_fn = _jax_losses(cfg, n_mem, n_img)[kind]
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    jb = jax.tree.map(jnp.asarray, batch)
    jl, jg = jax.jit(jax.value_and_grad(jloss_fn))(jparams, jb, sub)

    tp = params_from_numpy(_np(jparams), "cpu")
    leaves = {p: x for p, x in _leaves(tp).items()
              if not p.startswith("vit")}
    for x in leaves.values():
        x.requires_grad_(True)
    loss = ttrain.make_losses(cfg, torch.device("cpu"), PRE, n_mem,
                              _port_draws)[kind](tp, batch, (0, 0))
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    jgl = _jleaves(jg)
    assert not _grad_misses(leaves, grads, jgl)
    if modality == "features":         # NTM chunks of 3 valid frames
        assert float(np.abs(jgl["ntm/.wq"]).max()) > 0
        assert float(grads[list(leaves).index("ntm/.wq")].abs().max()) > 0


def test_planted_faults_fail_the_limits(tiny):
    """Each tolerance above refuses its planted fault, by at least 10x:
    labels shifted by one (the loss moves by > 1e-4 relative, read 2.1e-3;
    random weights keep every loss near log V); the NTM's parameters
    detached inside the port's loss (its gradients come out None, so
    zeros): the per-leaf check of test_modality_losses_and_grads passes
    the port's own gradients of this batch and under the fault refuses
    NTM leaves only, `ntm/.wq` among them (its error 1.1e-8 against a
    limit of 1.1e-11). The
    third, a pre segment padded on the wrong side, is held by
    tests/test_torch_llava_data.py's array equality."""
    cfg, jparams, tparams = tiny
    tok = ByteTokenizer()
    batch, n_mem = _video_batch(cfg, tok, "finetune")
    losses = ttrain.make_losses(cfg, torch.device("cpu"), PRE, n_mem,
                                _port_draws)
    jloss_fn = _jax_losses(cfg, n_mem, 0)["video"]
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    jl, jg = jax.jit(jax.value_and_grad(jloss_fn))(
        jparams, jax.tree.map(jnp.asarray, batch), sub)
    shifted = dict(batch, labels=np.roll(batch["labels"], 1, axis=1))
    bad = losses["video"](tparams, shifted, (0, 0)).item()
    assert abs(bad - float(jl)) / float(jl) > 1e-4
    good = losses["video"](tparams, batch, (0, 0)).item()
    np.testing.assert_allclose(good, float(jl), rtol=1e-5)

    jgl = _jleaves(jg)
    tp = params_from_numpy(_np(jparams), "cpu")
    leaves = {p: x for p, x in _leaves(tp).items()
              if not p.startswith("vit")}
    for x in leaves.values():
        x.requires_grad_(True)
    misses = {}
    for name, wrap in (("good", lambda p: p), ("fault", _ntm_detached)):
        loss = losses["video"](wrap(tp), batch, (0, 0))
        misses[name] = _grad_misses(leaves, torch.autograd.grad(
            loss, list(leaves.values()), allow_unused=True), jgl)
    assert not misses["good"]
    assert "ntm/.wq" in misses["fault"], misses
    assert all(p.startswith("ntm") for p in misses["fault"]), misses


@pytest.mark.parametrize("stage", ["pretrain", "finetune"])
def test_trainer_step_matches_jax(tiny, stage):
    """Two optimizer steps of each stage's recipe (the first at lr 0) over
    a video micro-batch of features: the port's Trainer against the JAX
    Trainer. Losses within 1e-5 relative; after step 2 every leaf within
    1e-4 of the larger of its max and the learning rate (Adam divides by
    sqrt(nu) + 1e-8, so a leaf whose gradient sits near 1e-8 carries its
    f32 noise into the step: the NTM's query bias reads 4.3e-5 of its max,
    and its key bias, whose gradient is zero in exact arithmetic, steps by
    noise of about 1e-6); pretrain leaves every `llm` and `vit` leaf bit-equal
    and moves `projector` and `ntm`, finetune leaves `vit` bit-equal and
    moves `llm`. A frozen leaf has requires_grad off, no .grad and no
    moment."""
    cfg, jparams, _ = tiny
    tok = ByteTokenizer()
    batch, n_mem = _video_batch(cfg, tok, stage)
    recipe = {"pretrain": (jrecipes.llava_pretrain, trecipes.llava_pretrain),
              "finetune": (jrecipes.llava_finetune,
                           trecipes.llava_finetune)}[stage]
    jcfg = dataclasses.replace(recipe[0](4), learning_rate=5e-3,
                               warmup_ratio=0.0)
    tcfg = dataclasses.replace(recipe[1](4), learning_rate=5e-3,
                               warmup_ratio=0.0)
    jt = JTrainer(_jax_losses(cfg, n_mem, 0)["video"],
                  jax.tree.map(jnp.array, jparams), jcfg,
                  mesh=create_mesh(dp=1, tp=1))
    tp = params_from_numpy(_np(jparams), "cpu")
    start = {p: x.clone() for p, x in _leaves(tp).items()}
    tt = ttrainer.Trainer(ttrain.make_losses(
        cfg, torch.device("cpu"), PRE, n_mem, _port_draws)["video"], tp,
        tcfg)
    stacked = jax.tree.map(lambda x: x[None], batch)
    for s in range(2):
        jl = jt.run_step(jax.tree.map(jnp.asarray, stacked),
                         jax.random.PRNGKey(s))
        tl = tt.run_step(stacked, s)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jleaves = _jleaves(jt.params)
    for p, x in _leaves(tt.params).items():
        want = np.asarray(jleaves[p], np.float32)
        diff = float(np.abs(x.detach().numpy() - want).max())
        assert diff < 1e-4 * max(float(np.abs(want).max()), 5e-3), p
        frozen = tt.optimizer.labels[p] == "frozen"
        assert x.requires_grad != frozen and x.grad is None, p
        assert (p in tt.opt_state["mu"]) != frozen, p
        moved = not torch.equal(x, start[p])
        if p.startswith("vit") or (stage == "pretrain"
                                   and p.startswith("llm")):
            assert frozen and not moved, p
    moved = {p.split("/")[0] for p, x in _leaves(tt.params).items()
             if not torch.equal(x, start[p])}
    assert moved == ({"projector", "ntm"} if stage == "pretrain"
                     else {"projector", "ntm", "llm"})


def test_update_in_slices_equals_whole(monkeypatch):
    """The update taken a few rows at a time (a stacked [4, 3, 5] leaf one
    layer a slice, a [7, 6] leaf in runs of 2 rows) equals the update taken
    whole, bit for bit, over three steps with grad_accum 2 (clipping off:
    the global norm's f32 sum runs in another order when sliced)."""
    rng = np.random.default_rng(0)
    base = {"llm": {"w": rng.normal(size=(4, 3, 5)).astype(np.float32),
                    "e": rng.normal(size=(7, 6)).astype(np.float32)},
            "projector": {"layers": [{"w": rng.normal(size=(5, 2))
                                      .astype(np.float32)}]}}
    batches = [{"x": rng.normal(size=(2, 3, 3)).astype(np.float32)}
               for _ in range(3)]

    def loss(p, b, key):
        x = torch.from_numpy(b["x"])
        h = torch.einsum("bi,lij->blj", x, p["llm"]["w"]).sum(1)
        return ((h @ p["projector"]["layers"][0]["w"]) ** 2).mean() \
            + (p["llm"]["e"] ** 2).sum() * 1e-2

    kw = dict(learning_rate=0.1, total_steps=3, grad_accum=2,
              max_grad_norm=1e9, warmup_ratio=0.0)
    runs = []
    for limit in (1 << 26, 12):
        monkeypatch.setattr(ttrainer, "UPDATE_SLICE", limit)
        params = jax.tree.map(torch.from_numpy, base)
        params = jax.tree.map(torch.clone, params)
        tr = ttrainer.Trainer(loss, params, ttrainer.TrainConfig(**kw))
        for s, b in enumerate(batches):
            tr.run_step(b, s)
        runs.append(_leaves(tr.params))
    assert len(ttrainer._slices(torch.zeros(4, 3, 5))) == 4
    for p in runs[0]:
        assert torch.equal(runs[0][p], runs[1][p]), p
    assert not torch.equal(runs[0]["llm/w"], torch.from_numpy(base["llm"]["w"]))


@pytest.mark.parametrize("lr", [2e-5, 5e-3])
def test_bf16_update_in_slices_matches_optax(monkeypatch, lr):
    """The finetune recipe's update on a bf16 tree (the card's stage 2:
    parameters, gradients and both moments in bf16), taken a slice at a
    time (a stacked [4, 16, 24] leaf one layer a slice, a [40, 16] leaf in
    runs of 24 rows), against optax's as JAX's trainer builds it
    (`make_optimizer`, jitted) on the same bf16 gradients: three steps (lr
    0, then the peak, then the cosine), the global norm about 2.6 so
    clipping acts, at the recipe's lr and at 5e-3. Every parameter and
    moment is bit-equal to optax's. The planted fault, a slice left out of
    the update, changes parameters."""
    import optax
    from flash_vstream_tpu.train.trainer import make_optimizer as jmake

    def bf16(x):
        return torch.from_numpy(np.asarray(x, np.float32)).bfloat16()

    rng = np.random.default_rng(0)
    shapes = {"llm": {"embed": (40, 16), "layers": {"w": (4, 16, 24)}},
              "projector": {"layers": [{"b": (8,), "w": (16, 8)}]},
              "vit": {"w": (8, 8)}}
    is_shape = lambda x: isinstance(x, tuple)
    p0 = jax.tree.map(lambda s: bf16(rng.normal(size=s) * 0.02), shapes,
                      is_leaf=is_shape)
    grads = [jax.tree.map(lambda s: bf16(rng.normal(size=s) * 0.05), shapes,
                          is_leaf=is_shape) for _ in range(3)]
    to_jax = lambda t: jax.tree.map(
        lambda x: jnp.asarray(x.float().numpy(), jnp.bfloat16), t)

    jp = to_jax(p0)
    tx = jmake(dataclasses.replace(jrecipes.llava_finetune(3),
                                   learning_rate=lr, projector_lr=lr), jp)
    js = tx.init(jp)

    @jax.jit
    def jstep(g, s, p):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    for g in grads:
        jp, js = jstep(to_jax(g), js, jp)
    want = {p: np.asarray(x.astype(jnp.float32))
            for p, x in _jleaves(jp).items()}
    norm = np.sqrt(sum(float((x.float() ** 2).sum())
                       for p, x in _leaves(grads[0]).items()
                       if p.startswith("llm")))
    assert norm > 1.0                  # the recipe's max_grad_norm

    monkeypatch.setattr(ttrainer, "UPDATE_SLICE", 384)
    tcfg = dataclasses.replace(trecipes.llava_finetune(3), learning_rate=lr,
                               projector_lr=lr)

    def run():
        tp = jax.tree.map(torch.clone, p0)
        opt = ttrainer.AdamW(tcfg, tp)
        state = opt.init(tp)
        for g in grads:
            state = opt.update(_leaves(g), state, tp)
        return _leaves(tp), state

    got, state = run()
    assert len(ttrainer._slices(got["llm/layers/w"])) == 4
    assert len(ttrainer._slices(got["llm/embed"])) == 2
    for p, x in got.items():
        assert x.dtype == torch.bfloat16
        np.testing.assert_array_equal(x.float().numpy(), want[p], err_msg=p)
    jadam = [s for s in jax.tree.leaves(
        js, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    jmu = {**_jleaves(jadam[0].mu), **_jleaves(jadam[1].mu)}
    for p in state["mu"]:
        np.testing.assert_array_equal(state["mu"][p].float().numpy(),
                                      np.asarray(jmu[p], np.float32),
                                      err_msg=p)
    moved = [p for p in got if not torch.equal(got[p], _leaves(p0)[p])]
    assert sorted(moved) == sorted(p for p in got if not p.startswith("vit"))

    real = ttrainer._slices
    monkeypatch.setattr(ttrainer, "_slices", lambda x: real(x)[:-1] or
                        real(x))
    bad, _ = run()
    assert not torch.equal(bad["llm/layers/w"], got["llm/layers/w"])


def _dry_args(out, data_path, feature_dir, steps, batch, extra=(),
              stage="finetune"):
    return ["--dry-run", "--output-dir", out, "--stage", stage,
            "--data-path", data_path, "--feature-dir", feature_dir,
            "--max-steps", str(steps), "--batch-size", str(batch),
            "--frame-bucket", str(BUCKET), "--pre-len", str(PRE),
            "--post-len", str(POST), "--learning-rate", "5e-3",
            "--save-steps", "100", *extra]


@pytest.mark.parametrize("stage", ["pretrain", "finetune"])
def test_run_training_matches_jax_and_resumes(tmp_path, tiny, stage):
    """`run_training --dry-run --stage <stage>` (pretrain: the `plain`
    template through the dataset, `recipes.llava_pretrain`'s projector and
    NTM groups and schedule; finetune: `v1`, `recipes.llava_finetune`)
    over JAX's own synthetic dataset (16 items of 5 frames: the 4 history
    frames fill the long memory, so no k-means on i.i.d. random features
    decides by rounding; the modality test runs it) with the JAX run's
    parameters and draws. JAX runs 6 steps of 8 samples at the same stage
    (its dry run is data-parallel over the 8 CPU devices). The port runs
    the same 6-step schedule with --save-steps 2, is stopped after its
    checkpoint at step 4 (by an exception in step 5), and resumes: the run
    takes steps 5 and 6 only, its step 5 equal bit for bit to the stopped
    run's. All 6 losses within 1e-4 relative of JAX's. A resume to 8
    then takes steps 7 and 8 only."""
    cfg, jparams, tparams = tiny
    data_path, feature_dir = jtrain.build_synthetic_dataset(
        str(tmp_path / "data"), JByte(), n_frames=5)
    B = len(jax.devices())
    jres = jtrain.run_training(jtrain.make_parser().parse_args(
        _dry_args(str(tmp_path / "jax"), data_path, feature_dir, 6, 1,
                  stage=stage)))

    def draws(step, micro, sample, n):
        return _port_draws(step, micro, sample, n, B)

    class Stop(Exception):
        pass

    seen = []

    def stop_at_5(step, trainer, record):
        seen.append(record["loss"])
        if step == 4:
            raise Stop

    out = str(tmp_path / "torch")
    args = ttrain.make_parser().parse_args(_dry_args(
        out, data_path, feature_dir, 6, B,
        ("--device", "cpu", "--save-steps", "2"), stage=stage))
    with pytest.raises(Stop):     # trains its parameters in place
        ttrain.run_training(args, cfg=cfg,
                            params=params_from_numpy(_np(jparams), "cpu"),
                            tokenizer=ByteTokenizer(), draws=draws,
                            on_step=stop_at_5)
    assert latest_checkpoint(out)[0] == 4 and len(seen) == 5
    resumed = ttrain.run_training(
        args, cfg=cfg, params=params_from_numpy(_np(jparams), "cpu"),
        tokenizer=ByteTokenizer(), draws=draws)
    assert len(resumed["losses"]) == 2 and latest_checkpoint(out)[0] == 6
    assert resumed["losses"][0] == seen[4]
    np.testing.assert_allclose(seen[:4] + resumed["losses"], jres["losses"],
                               rtol=1e-4)
    lines = [json.loads(s) for s in open(os.path.join(out, "scalars.jsonl"))]
    assert [r["step"] for r in lines] == list(range(1, 6)) + [5, 6]
    assert {"loss", "lr", "tokens_per_s", "modality"} <= set(lines[0])
    # then a resume to 8, as JAX's own test: steps 7 and 8 only
    more = ttrain.run_training(
        ttrain.make_parser().parse_args(_dry_args(
            out, data_path, feature_dir, 8, B, ("--device", "cpu"),
            stage=stage)),
        cfg=cfg, params=params_from_numpy(_np(jparams), "cpu"),
        tokenizer=ByteTokenizer(), draws=draws)
    assert len(more["losses"]) == 2 and latest_checkpoint(out)[0] == 8
    assert all(np.isfinite(more["losses"]))


def test_raw_media_dry_run(tmp_path):
    """The raw-media dry run (`.npy` frame directories, `.npy` images and
    text items): video, image and text steps interleave and every loss is
    finite and above 0; pretrain moves the projector and leaves every
    `llm` and `vit` leaf bit-equal, and under --save-steps 0 writes no
    checkpoint."""
    out = str(tmp_path / "raw")
    res = ttrain.run_training(ttrain.make_parser().parse_args(
        ["--dry-run", "--synthetic-raw", "--device", "cpu", "--output-dir",
         out, "--stage", "finetune", "--max-steps", "6", "--frame-bucket",
         "4", "--pre-len", str(PRE), "--post-len", str(POST),
         "--save-steps", "100", "--learning-rate", "5e-3"]))
    assert set(res["modalities"]) == {"video", "image", "text"}
    assert all(np.isfinite(v) and v > 0 for v in res["losses"]), res
    cfg = tiny_llava_config()
    start = tvl.init_llava_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    pre = ttrain.run_training(ttrain.make_parser().parse_args(
        ["--dry-run", "--synthetic-raw", "--device", "cpu", "--output-dir",
         str(tmp_path / "pre"), "--stage", "pretrain", "--max-steps", "3",
         "--frame-bucket", "4", "--pre-len", str(PRE), "--post-len",
         str(POST), "--save-steps", "0"]))
    assert latest_checkpoint(str(tmp_path / "pre")) is None
    moved = {p for p, x in _leaves(pre["params"]).items()
             if not torch.equal(x, _leaves(start)[p])}
    # the NTM has no gradient here (3 history frames fill the Turing memory)
    assert moved and all(p.startswith("projector") for p in moved), moved


def test_unported_options_raise(tmp_path):
    parse = lambda *a: ttrain.make_parser().parse_args(
        ["--device", "cpu", "--output-dir", str(tmp_path), *a])
    with pytest.raises(ValueError, match="--model-path"):
        ttrain.run_training(parse())
    for flags in (("--tp", "2"), ("--zero-stage", "3"),
                  ("--offload-moments",)):
        with pytest.raises(NotImplementedError, match="A16"):
            ttrain.run_training(parse("--dry-run", *flags))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttrain.run_training(ttrain.make_parser().parse_args(
                ["--dry-run", "--output-dir", str(tmp_path)]))


def test_short_bucket_consolidates_as_a_padded_one(tiny):
    """A frame bucket shorter than a memory section (3 frames against the
    tiny config's 4 long-memory slots; at full width any bucket under 25)
    fails in JAX on its shapes; the port pads it with zero frames, which
    gives JAX's consolidation of the same frames in a bucket of 8 (tokens
    within 1e-5 of max, validity equal)."""
    cfg, jparams, tparams = tiny
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 64, 32)).astype(np.float32)
    padded = np.concatenate([x, np.zeros((5, 64, 32), np.float32)])
    key = jax.random.PRNGKey(2)
    want = jvl.consolidate(jparams, cfg, jnp.asarray(padded), 3, key)
    got = tvl.consolidate(tparams, cfg, torch.from_numpy(x), 3,
                          lambda n: torch.from_numpy(np.array(
                              jax.random.uniform(key, (n,)))))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert _err(got.tokens, want.tokens) < 1e-5
    with pytest.raises(Exception):
        jvl.consolidate(jparams, cfg, jnp.asarray(x), 3, key)
