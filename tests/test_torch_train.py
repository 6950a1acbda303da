"""The training slice of the port against JAX at the tiny config, in f32 on
the CPU: the chunked ViT encode, offline Flash memory consolidation with
k-means running (the JAX draws carried across), the dynamic splice and rope
positions, one sample's LoRA loss and adapter gradients against
jax.value_and_grad of the JAX composition, three optimizer steps of
`Trainer`, `run_training --dry-run` against the JAX `run_training`, and
checkpoint resume. Tolerances are stated per test."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_vstream_tpu.core.config import tiny_qwen_config
from flash_vstream_tpu.models import flash_memory as jfm
from flash_vstream_tpu.models import qwen2_vit as jvit
from flash_vstream_tpu.models import vstream_qwen as jvq
from flash_vstream_tpu.preprocess import video as jvideo
from flash_vstream_tpu.preprocess.qwen_processor import (
    make_byte_qwen_tokenizer as jtokenizer)
from flash_vstream_tpu.train import finetune_flash as jft
from flash_vstream_tpu.train import lora as jlora
from flash_vstream_tpu.train.data import proportional_schedule as jschedule
from flash_vstream_tpu.train.reporting import lr_at as jlr_at
from flash_vstream_tpu_torch.models import flash_memory as tfm
from flash_vstream_tpu_torch.models import qwen2_vit as tvit
from flash_vstream_tpu_torch.models import vstream_qwen as tvq
from flash_vstream_tpu_torch.preprocess import video as tvideo
from flash_vstream_tpu_torch.preprocess.image import qwen_preprocess
from flash_vstream_tpu_torch.preprocess.qwen_processor import (
    make_byte_qwen_tokenizer)
from flash_vstream_tpu_torch.train import finetune_flash as tft
from flash_vstream_tpu_torch.train import trainer as ttrainer
from flash_vstream_tpu_torch.train.checkpoint import latest_checkpoint
from flash_vstream_tpu_torch.train.data import proportional_schedule
from flash_vstream_tpu_torch.train.lora import QWEN_TARGETS
from flash_vstream_tpu_torch.train.reporting import lr_at
from flash_vstream_tpu_torch.weights.from_jax import (lora_from_numpy,
                                                      params_from_numpy)

torch.set_num_threads(1)
RANK, ALPHA = 4, 8.0


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(torch.as_tensor(got).detach().float().numpy(),
                               want, atol=rel * scale, err_msg=what)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_qwen_config()
    jparams = jvq.init_qwen_params(jax.random.PRNGKey(0), cfg)
    return cfg, jparams, params_from_numpy(_np(jparams), "cpu")


def _video(seed, n_frames, side=56):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
            for _ in range(n_frames)]


def _scenes(seed, sizes, side=56):
    """Frame pairs in scenes of random textures, each scene an exact pair
    followed by noisy ones (returned with each pair's scene). With one
    k-means init seed in each scene, every distance that k-means and the DAM
    retrieval compare differs by a wide margin (a scene's exact pair is the
    clear nearest frame to its mean), so the two frameworks cannot decide
    differently on rounding noise."""
    rng = np.random.default_rng(seed)
    frames, scene = [], []
    for i, size in enumerate(sizes):
        texture = rng.integers(0, 256, (side, side, 3))
        for j in range(size):
            f = texture + (rng.integers(-24, 25, texture.shape) if j else 0)
            frames += [f.clip(0, 255).astype(np.uint8)] * 2
            scene.append(i)
    return frames, np.asarray(scene)


def test_vit_encode_frames_chunked(tiny):
    """Frame chunks of 2 against the JAX chunked encode (1e-4 x max: two
    layers of f32 matmuls) and against the port's one-shot encode."""
    cfg, jparams, tparams = tiny
    patches, grid = qwen_preprocess(_video(0, 8))          # t=4, 4x4 grid
    t, h, w = grid
    small, sgrid = jvq.qwen_temporal_pool(jnp.asarray(patches), grid,
                                          cfg.vit.patch_size)
    pd = patches.shape[-1]
    full = patches.reshape(t, h * w, pd)
    small = np.asarray(small).reshape(t, sgrid[1] * sgrid[2], pd)
    kw = dict(hw_full=(h, w), hw_small=(sgrid[1], sgrid[2]), chunk=2)
    jx, jsx = jvit.qwen_vit_encode_frames_chunked(
        jparams["vit"], cfg.vit, jnp.asarray(full), jnp.asarray(small), **kw)
    tx, tsx = tvit.qwen_vit_encode_frames_chunked(
        tparams["vit"], cfg.vit, torch.from_numpy(full),
        torch.from_numpy(small), **kw)
    _close(tx, jx, 1e-4)
    _close(tsx, jsx, 1e-4)
    one = tvit.qwen_vit_blocks_frames(
        tparams["vit"], cfg.vit,
        torch.cat([torch.from_numpy(full).reshape(-1, pd),
                   torch.from_numpy(small).reshape(-1, pd)]),
        t_full=t, hw_full=(h, w), t_small=t, hw_small=(sgrid[1], sgrid[2]))
    _close(tx.reshape(-1, tx.shape[-1]), one[:t * h * w].numpy(), 1e-5)


@pytest.mark.parametrize("t,spatial", [(7, "klarge_retrieve"),
                                       (7, "klarge_retrieve_cos"),
                                       (7, "sample"), (7, "nearest"),
                                       (3, "klarge_retrieve")])
def test_flash_consolidate(tiny, t, spatial):
    """Offline consolidation: t = 7 frame pairs above the 4-cluster CSM grid
    runs k-means (the port takes the JAX key's uniform draws), and above the
    2-frame DAM grid runs the spatial method; t = 3 keeps every pooled frame.
    Features 1e-4 x max (ten Lloyd iterations in f32), positions exact."""
    import dataclasses
    cfg = dataclasses.replace(tiny[0].flash_memory, spatial_method=spatial)
    rng = np.random.default_rng(t)
    centers = rng.normal(size=(3, 4 * 32)) * 3
    small = (centers[rng.integers(0, 3, t)]
             + rng.normal(size=(t, 4 * 32))).reshape(t, 4, 32)
    x = rng.normal(size=(t, 16, 32))
    x, small = x.astype(np.float32), small.astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jfm.flash_consolidate(cfg, jnp.asarray(x), jnp.asarray(small),
                                 key=key)
    got = tfm.flash_consolidate(
        cfg, torch.from_numpy(x), torch.from_numpy(small),
        init_scores=torch.from_numpy(np.array(jax.random.uniform(key, (t,)))))
    for name in ("spa_x", "tem_x", "tem_weights"):
        _close(getattr(got, name), getattr(want, name), 1e-4, name)
    for name in ("spa_positions", "tem_positions"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    _close(tfm.cat_spa_tem(got.spa_x, got.tem_x),
           jfm.cat_spa_tem(want.spa_x, want.tem_x), 1e-4)


def test_positions_and_splice():
    """The static and dynamic rope builders and the dynamic splice equal
    JAX's exactly at every start."""
    vis = jvq.mm_grid_index(2, 4, 4).astype(np.int32)
    n_vis, S = vis.shape[1], 64
    tvis = torch.from_numpy(vis)
    for start in (0, 3, 17, S - n_vis):
        jp, jd = jvq.build_qwen_positions(S, start, n_vis, jnp.asarray(vis))
        tp, td = tvq.build_qwen_positions(S, start, n_vis, tvis)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        jp2, jd2 = jvq.build_qwen_positions_dynamic(S, jnp.int32(start),
                                                    n_vis, jnp.asarray(vis))
        tp2, td2 = tvq.build_qwen_positions_dynamic(S, start, n_vis, tvis)
        np.testing.assert_array_equal(tp2.numpy(), np.asarray(jp2))
        assert int(td) == int(jd) == int(td2) == int(jd2)
    emb = np.random.default_rng(0).normal(size=(1, 10, 4)).astype(np.float32)
    blk = np.ones((3, 4), np.float32)
    want = jvq.splice_embeds_dynamic(jnp.asarray(emb), jnp.asarray(blk),
                                     jnp.int32(2))
    e = torch.from_numpy(emb).requires_grad_()
    b = torch.from_numpy(blk).requires_grad_()
    got = tvq.splice_embeds_dynamic(e, b, 2)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.sum().backward()                      # no in-place write into a leaf
    assert e.grad[0, 2:5].sum() == 0 and b.grad.sum() == 12


def test_preprocess_qwen_sample_matches_jax(tiny):
    cfg = tiny[0]
    item = {"conversations": [
        {"from": "human", "value": "<video>\nWhat is shown?"},
        {"from": "gpt", "value": "A red car."},
        {"from": "human", "value": "And after that?"},
        {"from": "gpt", "value": "It drives away."}]}
    want = jft.preprocess_qwen_sample(item, jtokenizer(), cfg, (6, 4, 4),
                                      max_len=256)
    got = tft.preprocess_qwen_sample(item, make_byte_qwen_tokenizer(), cfg,
                                     (6, 4, 4), max_len=256)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]


def _sample(cfg, frames, max_len):
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


def _adapters(jparams, seed):
    """The JAX init's adapters with b != 0 (so `a` has a gradient)."""
    jl = jlora.init_lora_params(jax.random.PRNGKey(seed), jparams, rank=RANK,
                                targets=jlora.QWEN_TARGETS)
    rng = np.random.default_rng(seed)
    return {p: {"a": ab["a"],
                "b": jnp.asarray(0.1 * rng.normal(size=ab["b"].shape),
                                 jnp.float32)}
            for p, ab in jl.items()}


def test_one_sample_loss_and_grads(tiny):
    """One video (12 frame pairs in 4 scenes of 5, 4, 2 and 1 pairs:
    k-means into 4 clusters and DAM retrieval both run) through the port's `sample_loss` and through
    jax.value_and_grad of the JAX `one_sample` composition, f32 base with
    the adapters cast to bf16 (as in training; the merger then runs in
    bf16). Loss within 1e-4 relative; every adapter gradient within
    5e-2 x its max: the gradients come back through the f32 -> bf16 casts
    of the adapters, so they are bf16 values (one ulp is 0.4-0.8% of a
    value), and the bf16 merger's output differs by an ulp here and there
    between the frameworks, which reaches every decoder gradient (measured
    worst 2.1e-2, on wk's a)."""
    cfg, jparams, tparams = tiny
    max_len = 160
    frames, scene = _scenes(1, (5, 4, 2, 1))
    patches, grid, ids, labels, (start, n_vis), seg = _sample(cfg, frames,
                                                              max_len)
    K = cfg.flash_memory.csm_grid_len
    # the first key whose draws seed k-means with one pair of each scene
    key = next(k for k in map(jax.random.PRNGKey, range(100))
               if len(set(scene[np.argsort(np.asarray(
                   jax.random.uniform(k, (grid[0],))))[:K]])) == K)
    jl = _adapters(jparams, 3)

    def one_sample(lora_params):
        lp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), lora_params)
        eff = jlora.lora_views(jparams, lp, alpha=ALPHA, rank=RANK)
        vis = jvq.encode_video(eff, cfg, jnp.asarray(patches), grid, key=key,
                               vit_chunk=4, vit_remat=True)
        positions, _ = jvq.build_qwen_positions_dynamic(
            max_len, jnp.int32(start), n_vis, vis.visual_positions)
        from flash_vstream_tpu.models import llm as jllm
        embeds = jllm.embed_tokens(eff["llm"], jnp.asarray(ids)[None])
        embeds = jvq.splice_embeds_dynamic(embeds, vis.video_embeds,
                                           jnp.int32(start))
        h, _ = jllm.decoder_forward(eff["llm"], cfg.llm, embeds, positions,
                                    segment_ids=jnp.asarray(seg)[None],
                                    remat=True)
        return jllm.cross_entropy_loss(jllm.lm_head(eff["llm"], cfg.llm, h),
                                       jnp.asarray(labels)[None])
    jloss, jg = jax.value_and_grad(one_sample)(jl)

    tl = lora_from_numpy(_np(jl), "cpu")
    for ab in tl.values():
        for x in ab.values():
            x.requires_grad_()
    draws = torch.from_numpy(np.array(jax.random.uniform(key, (grid[0],))))
    loss = tft.sample_loss(cfg, tparams, tl, torch.from_numpy(patches), grid,
                           torch.from_numpy(ids), torch.from_numpy(labels),
                           torch.from_numpy(seg), start, n_vis, draws,
                           alpha=ALPHA, rank=RANK, vit_chunk=4)
    leaves = [(p, k, x) for p, ab in sorted(tl.items())
              for k, x in sorted(ab.items())]
    grads = torch.autograd.grad(loss, [x for *_, x in leaves])
    assert grid[0] > cfg.flash_memory.csm_grid_len
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    for (p, k, _), g in zip(leaves, grads):
        assert g.abs().max() > 0, f"{p}/{k}"
        _close(g, jg[p][k], 5e-2, f"{p}/{k}")


def test_trainer_matches_jax():
    """Three optimizer steps, grad_accum 2, clipping active, a projector
    group with its own lr, weight decay and a frozen leaf: the port's
    Trainer against the JAX Trainer (optax). Parameters within 1e-5
    relative; the first step runs at lr 0."""
    from flash_vstream_tpu.parallel.sharding import create_mesh
    from flash_vstream_tpu.train.trainer import TrainConfig as JCfg
    from flash_vstream_tpu.train.trainer import Trainer as JTrainer
    rng = np.random.default_rng(0)
    params = {"projector": {"w": rng.normal(size=(4, 3))},
              "llm": {"w": rng.normal(size=(3, 2))},
              "frozen": {"w": rng.normal(size=(2,))}}
    params = jax.tree.map(lambda x: x.astype(np.float32), params)
    batches = [{"x": rng.normal(size=(2, 4, 4)).astype(np.float32),
                "y": rng.normal(size=(2, 4, 2)).astype(np.float32)}
               for _ in range(3)]
    kw = dict(learning_rate=0.1, projector_lr=0.05, weight_decay=0.01,
              total_steps=3, grad_accum=2, max_grad_norm=0.5,
              frozen=(r"^frozen",))

    def jloss(p, b, key):
        pred = b["x"] @ p["projector"]["w"] @ p["llm"]["w"] + p["frozen"]["w"]
        return jnp.mean((pred - b["y"]) ** 2)

    def tloss(p, b, key):
        x, y = torch.from_numpy(b["x"]), torch.from_numpy(b["y"])
        pred = x @ p["projector"]["w"] @ p["llm"]["w"] + p["frozen"]["w"]
        return ((pred - y) ** 2).mean()

    jt = JTrainer(jloss, jax.tree.map(jnp.asarray, params), JCfg(**kw),
                  mesh=create_mesh(dp=1, tp=1))
    tt = ttrainer.Trainer(tloss, jax.tree.map(torch.from_numpy, params),
                          ttrainer.TrainConfig(**kw))
    start = jax.tree.map(np.array, params)
    for s, b in enumerate(batches):
        jl = jt.run_step(jax.tree.map(jnp.asarray, b), jax.random.PRNGKey(s))
        tl = tt.run_step(b, s)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        if s == 0:       # lr 0 at the first step
            for name in ("projector", "llm"):
                np.testing.assert_array_equal(
                    tt.params[name]["w"].detach().numpy(), start[name]["w"])
    for name in ("projector", "llm", "frozen"):
        np.testing.assert_allclose(tt.params[name]["w"].detach().numpy(),
                                   np.asarray(jt.params[name]["w"]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(tt.params["frozen"]["w"].detach().numpy(),
                                  start["frozen"]["w"])
    assert not np.allclose(tt.params["llm"]["w"].detach().numpy(),
                           start["llm"]["w"])


def _dry_args(out, data_path, video_dir, steps, frames=12):
    return ["--dry-run", "--output-dir", out, "--data-path", data_path,
            "--video-dir", video_dir, "--max-steps", str(steps),
            "--grad-accum", "1", "--max-frames", str(frames),
            "--frame-bucket", str(frames),
            "--max-len", "128", "--max-pixels", str(56 * 56),
            "--lora-rank", str(RANK), "--lora-alpha", str(ALPHA),
            "--learning-rate", "5e-3", "--save-steps", "1"]


def test_run_training_matches_jax(tmp_path, tiny):
    """`run_training --dry-run --max-steps 2` on `build_synthetic_dataset`
    (4 frame pairs: every pooled frame is a CSM slot and DAM retrieval
    runs; k-means on i.i.d. random frames would decide by rounding noise,
    test_one_sample_loss_and_grads holds it) with the JAX run's parameters,
    adapters and draws carried across: losses within 1e-4 relative, final
    adapters (moved by the second step's Adam update) within 1e-4 x max in
    99% of their elements."""
    from flash_vstream_tpu.train.checkpoint import restore_checkpoint
    cfg, jparams, tparams = tiny
    data_path, video_dir = jft.build_synthetic_dataset(
        str(tmp_path / "data"), n_items=4, n_frames=8)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jres = jft.run_training(jft.make_parser().parse_args(
        _dry_args(jout, data_path, video_dir, 2, frames=8)))
    B = len(jax.devices())          # the JAX dry run is data-parallel

    def draws(step, micro, sample, n):
        _, sub = jax.random.split(jax.random.PRNGKey(step))
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.split(sub, B)[sample], (n,))))

    jl = jlora.init_lora_params(jax.random.PRNGKey(1), jparams, rank=RANK,
                                targets=jlora.QWEN_TARGETS)
    args = tft.make_parser().parse_args(
        _dry_args(tout, data_path, video_dir, 2, frames=8)
        + ["--device", "cpu", "--batch-size", str(B)])
    tres = tft.run_training(args, cfg=cfg, params=tparams,
                            lora=lora_from_numpy(_np(jl), "cpu"),
                            kmeans_draws=draws)
    np.testing.assert_allclose(tres["losses"], jres["losses"], rtol=1e-4)
    # Adam moves every element by about lr whatever its gradient's size, so
    # an element whose gradient is rounding noise may step either way: 99%
    # of the elements agree to 1e-4 x max
    _, payload = restore_checkpoint(jout)
    for p, ab in tres["lora"].items():
        for k, x in ab.items():
            want = np.asarray(payload["params"][p][k])
            near = (np.abs(x.detach().numpy() - want)
                    <= 1e-4 * np.abs(want).max())
            assert near.mean() >= 0.99, f"{p}/{k}: {near.mean()}"
    lines = [json.loads(s) for s in open(os.path.join(tout, "scalars.jsonl"))]
    assert [r["step"] for r in lines] == [1, 2]
    assert {"loss", "lr", "tokens_per_s", "step_time_s"} <= set(lines[0])


def test_resume_from_checkpoint(tmp_path):
    """2 steps, then a run to 3 steps resumes from checkpoint-2 and ends
    where an uninterrupted 3-step run ends (1e-6 x max)."""
    data_path, video_dir = tft.build_synthetic_dataset(
        str(tmp_path / "data"), n_items=3, n_frames=4)
    args = lambda out, steps: tft.make_parser().parse_args(
        ["--device", "cpu"] + _dry_args(out, data_path, video_dir, steps))
    a = str(tmp_path / "a")
    tft.run_training(args(a, 2))
    assert latest_checkpoint(a)[0] == 2
    resumed = tft.run_training(args(a, 3))
    assert len(resumed["losses"]) == 1 and latest_checkpoint(a)[0] == 3
    whole = tft.run_training(args(str(tmp_path / "b"), 3))
    for p, ab in whole["lora"].items():
        for k, x in ab.items():
            _close(resumed["lora"][p][k], x.detach().numpy(), 1e-6, p)


def test_video_sources(tmp_path):
    """SyntheticSource equals JAX's frames; registered decoders, frame
    directories and the probes; containers raise (ROADMAP A1)."""
    j, t = jvideo.SyntheticSource(5, 16, 24, seed=3), tvideo.SyntheticSource(
        5, 16, 24, seed=3)
    assert len(t) == 5 and all(np.array_equal(a, b) for a, b in zip(t, j))
    tvideo.register_video_decoder(
        "fake", lambda path, fps: list(tvideo.SyntheticSource(9, 8, 8)))
    src = tvideo.load_video(str(tmp_path / "x.fake"), max_frames=3)
    assert len(src) == 3 and src[0].shape == (8, 8, 3)
    assert tvideo.probe_video_len(str(tmp_path / "x.fake")) == 9
    assert tvideo.probe_video_hw(str(tmp_path / "x.fake")) == (8, 8)
    _, video_dir = tft.build_synthetic_dataset(str(tmp_path / "d"), n_items=1,
                                               n_frames=5, side=56)
    d = os.path.join(video_dir, "v0")
    assert tvideo.probe_video_len(d) == 5
    assert tvideo.probe_video_hw(d) == (56, 56)
    frames = tvideo.load_video(d, max_frames=3)
    want = jvideo.load_video(d, max_frames=3)
    assert all(np.array_equal(a, b) for a, b in zip(frames, want))
    with pytest.raises(NotImplementedError, match="A1"):
        tvideo.load_video(str(tmp_path / "clip.mp4"))


def test_schedules_match_jax():
    sizes = {"a": 9, "b": 1, "c": 3}
    assert proportional_schedule(sizes, 20) == jschedule(sizes, 20)
    cfg = ttrainer.TrainConfig(learning_rate=8e-4, total_steps=100)
    for step in (0, 1, 2, 3, 50, 99, 120):
        assert lr_at(cfg, step) == jlr_at(cfg, step)
    assert lr_at(cfg, 0) == 0.0


def test_entry_points_default_to_the_card(tmp_path, tiny):
    """No device means CUDA; without a card that raises, and only
    device='cpu' / --device cpu runs here."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cfg = tiny[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvq.init_qwen_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tft.run_training(tft.make_parser().parse_args(
            ["--dry-run", "--output-dir", str(tmp_path)]))


def test_unported_paths_raise(tmp_path, tiny):
    import dataclasses
    cfg, _, tparams = tiny
    parse = lambda *a: tft.make_parser().parse_args(
        ["--device", "cpu", "--output-dir", str(tmp_path), *a])
    with pytest.raises(NotImplementedError, match="A10"):
        tft.run_training(parse())                        # no checkpoint
    with pytest.raises(NotImplementedError, match="A16"):
        tft.run_training(parse("--dry-run", "--pp", "2"))
    with pytest.raises(NotImplementedError, match="A10/A12"):
        tft.run_training(parse("--dry-run", "--int8-base"))
    with pytest.raises(NotImplementedError, match="A3"):
        tft.build_synthetic_dataset(str(tmp_path / "d"), n_images=1)
    with pytest.raises(NotImplementedError, match="A3"):
        tvq.encode_image(tparams, cfg, None, (4, 4))
    x = torch.zeros(6, 4, 8)
    fm = dataclasses.replace(cfg.flash_memory, temporal_method="sample")
    with pytest.raises(NotImplementedError, match="A14"):
        tfm.flash_consolidate(fm, x, x)
    with pytest.raises(NotImplementedError, match="A16"):
        ttrainer.Trainer(lambda p, b, k: 0, {"w": torch.zeros(2)},
                         ttrainer.TrainConfig(zero_stage=3))
    assert QWEN_TARGETS[-1] == r"merger/fc[12]/w$"
