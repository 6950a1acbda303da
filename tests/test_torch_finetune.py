"""The fine-tuning entry's checkpoint paths in the port against JAX at the
tiny config, on the CPU: `run_training --model-path` from a checkpoint the
port wrote, the `--export-merged` file of a QLoRA run (read back by
`safetensors.numpy`, key for key against JAX's `export_safetensors` of the
same merged tree), `merge_lora_weights.py` end to end, `apply_lora_adapter`
and still-image training items (one image sample's loss and gradients, and
`run_training` over a mixed image and video dataset against the JAX run).
Tolerances are stated per test."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_vstream_tpu.core.config import tiny_qwen_config
from flash_vstream_tpu.models import llm as jllm
from flash_vstream_tpu.models import vstream_qwen as jvq
from flash_vstream_tpu.train import checkpoint as jckpt
from flash_vstream_tpu.train import finetune_flash as jft
from flash_vstream_tpu.train import lora as jlora
from flash_vstream_tpu.weights import convert as jconvert
from flash_vstream_tpu.weights import quantize as jq
from flash_vstream_tpu_torch.preprocess.image import qwen_preprocess
from flash_vstream_tpu_torch.preprocess.qwen_processor import (
    make_byte_qwen_tokenizer)
from flash_vstream_tpu_torch.scripts import merge_lora_weights
from flash_vstream_tpu_torch.train import finetune_flash as tft
from flash_vstream_tpu_torch.train.checkpoint import save_checkpoint
from flash_vstream_tpu_torch.weights import convert as tconvert
from flash_vstream_tpu_torch.weights import quantize as tq
from flash_vstream_tpu_torch.weights.from_jax import (lora_from_numpy,
                                                      params_from_numpy)
from flash_vstream_tpu_torch.weights.safetensors_io import load_file

torch.set_num_threads(1)
RANK, ALPHA = 4, 8.0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(torch.as_tensor(got).detach().float().numpy(),
                               want, atol=rel * scale, err_msg=what)


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_qwen_config()
    jparams = jvq.init_qwen_params(jax.random.PRNGKey(0), cfg)
    return cfg, jparams, params_from_numpy(_np(jparams), "cpu")


def _adapters(jparams, seed):
    jl = jlora.init_lora_params(jax.random.PRNGKey(seed), jparams, rank=RANK,
                                targets=jlora.QWEN_TARGETS)
    rng = np.random.default_rng(seed)
    return {p: {"a": ab["a"],
                "b": jnp.asarray(0.1 * rng.normal(size=ab["b"].shape),
                                 jnp.float32)}
            for p, ab in jl.items()}


def _args(out, data_path, video_dir, steps, *extra):
    return tft.make_parser().parse_args([
        "--device", "cpu", "--output-dir", out, "--data-path", data_path,
        "--video-dir", video_dir, "--max-steps", str(steps),
        "--grad-accum", "1", "--max-frames", "4", "--frame-bucket", "4",
        "--max-len", "128", "--max-pixels", str(56 * 56),
        "--lora-rank", str(RANK), "--lora-alpha", str(ALPHA),
        "--learning-rate", "5e-3", "--save-steps", "1", *extra])


def test_model_path_matches_params_handed_in(tmp_path):
    """`--model-path DIR` (a checkpoint written by the port's
    `save_hf_checkpoint`, its config.json and HF tokenizer) trains as the
    same bf16 weights, config and tokenizer handed in: equal losses, two
    steps; with --int8-base too."""
    from flash_vstream_tpu_torch.preprocess.tokenizer import load_tokenizer
    from flash_vstream_tpu_torch.weights.convert import (load_qwen_checkpoint,
                                                         qwen_config_from_hf)
    from torch_ckpt import write_tiny_checkpoint
    ckpt = str(tmp_path / "ckpt")
    write_tiny_checkpoint(ckpt)
    data_path, video_dir = tft.build_synthetic_dataset(
        str(tmp_path / "data"), n_items=2, n_frames=4)
    for extra in ((), ("--int8-base",)):
        tag = "q" if extra else "b"
        a = tft.run_training(_args(str(tmp_path / f"a{tag}"), data_path,
                                   video_dir, 2, "--model-path", ckpt,
                                   *extra))
        cfg = qwen_config_from_hf(ckpt)
        b = tft.run_training(
            _args(str(tmp_path / f"b{tag}"), data_path, video_dir, 2, *extra),
            cfg=cfg, params=load_qwen_checkpoint(ckpt, cfg,
                                                 dtype=torch.bfloat16,
                                                 device="cpu"),
            tokenizer=load_tokenizer(ckpt))
        assert len(a["losses"]) == 2 and all(np.isfinite(a["losses"]))
        assert a["losses"] == b["losses"], (extra, a["losses"], b["losses"])


@pytest.fixture(scope="module")
def qlora_export(tiny, tmp_path_factory):
    """One `run_training --int8-base --base-bits 4 --export-merged` step
    (lr 0: the adapters stay the JAX ones handed in, b != 0) and the JAX
    export of the same merged tree."""
    cfg, jparams, tparams = tiny
    tmp = tmp_path_factory.mktemp("export")
    data_path, video_dir = tft.build_synthetic_dataset(
        str(tmp / "data"), n_items=1, n_frames=4)
    jbase = jq.quantize_params4(jparams)
    jl = _adapters(jbase, 2)
    out = str(tmp / "run")
    res = tft.run_training(
        _args(out, data_path, video_dir, 1, "--int8-base", "--base-bits", "4",
              "--export-merged"),
        cfg=cfg, params=tparams, lora=lora_from_numpy(_np(jl), "cpu"))
    want = str(tmp / "jax.safetensors")
    jckpt.export_safetensors(want, jlora.merge_lora(jbase, jl, ALPHA, RANK))
    return res, want, tmp, out


def test_export_merged_matches_jax(qlora_export):
    """The port's file holds JAX's keys and no other, each with JAX's dtype
    and shape: the adapted leaves dequantized and merged in f32 (1e-6 x
    max), the rest bit for bit (the f32 leaves, and the int4 `.q4` and
    `.scale` fields of the lm_head and the ViT's MLP blocks); both files
    read by `safetensors.numpy`."""
    from safetensors.numpy import load_file as np_load
    res, want_path, _, out = qlora_export
    assert res["merged_path"] == os.path.join(out, "model_merged.safetensors")
    got, want = np_load(res["merged_path"]), np_load(want_path)
    assert sorted(got) == sorted(want)
    assert {"llm.lm_head.q4", "llm.lm_head.scale",
            "llm.layers.attn.wq.w", "vit.merger.fc1.w"} <= set(got)
    merged = {p.replace("/", ".") for p in res["lora"]}
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k in merged:
            _close(g, w, 1e-6, k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert merged <= set(got) and len(merged) == 9


def test_merge_lora_weights_script(qlora_export, tiny):
    """The script over the port's own checkpoints (the int4 base saved with
    `save_checkpoint`, the run's adapters) writes the run's export, tensor
    for tensor."""
    res, _, tmp, out = qlora_export
    base_dir = str(tmp / "base")
    save_checkpoint(base_dir, 0, tq.quantize_params4(tiny[2]))
    path = merge_lora_weights.main([
        "--base-checkpoint", base_dir, "--lora-checkpoint", out,
        "--output", str(tmp / "script.safetensors"), "--rank", str(RANK),
        "--alpha", str(ALPHA), "--device", "cpu"])
    got, want = load_file(path), load_file(res["merged_path"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_apply_lora_adapter_matches_jax(tiny):
    """torch-PEFT deltas on layers 0 and 1 of four projections merged into
    the stacked decoder tree: JAX's values (1e-6 x max), the base tree
    unchanged, untouched leaves the same tensors."""
    cfg, jparams, tparams = tiny
    rng = np.random.default_rng(0)
    shapes = {"q_proj": ("self_attn", 64, 64), "v_proj": ("self_attn", 32, 64),
              "down_proj": ("mlp", 64, 128),
              "gate_proj": ("mlp", 128, 64)}    # torch [out, in]
    sd = {}
    for i in (0, 1):
        for proj, (grp, o, n) in shapes.items():
            pre = f"base_model.model.model.layers.{i}.{grp}.{proj}"
            sd[f"{pre}.lora_A.weight"] = rng.normal(
                size=(RANK, n)).astype(np.float32)
            sd[f"{pre}.lora_B.weight"] = rng.normal(
                size=(o, RANK)).astype(np.float32)
    want = jconvert.apply_lora_adapter(jparams["llm"], sd, ALPHA, RANK)
    before = tparams["llm"]["layers"]["attn"]["wq"]["w"].clone()
    got = tconvert.apply_lora_adapter(tparams["llm"], sd, ALPHA, RANK)
    for grp, name in (("attn", "wq"), ("attn", "wv"), ("mlp", "down"),
                      ("mlp", "gate")):
        _close(got["layers"][grp][name]["w"],
               want["layers"][grp][name]["w"], 1e-6, name)
        assert not torch.equal(got["layers"][grp][name]["w"],
                               tparams["llm"]["layers"][grp][name]["w"])
    assert torch.equal(tparams["llm"]["layers"]["attn"]["wq"]["w"], before)
    assert got["layers"]["attn"]["wk"] is tparams["llm"]["layers"]["attn"]["wk"]
    with pytest.raises(ValueError, match="incomplete"):
        tconvert.apply_lora_adapter(tparams["llm"], {
            "model.layers.0.self_attn.q_proj.lora_A.weight": sd[
                "base_model.model.model.layers.0.self_attn.q_proj"
                ".lora_A.weight"]}, ALPHA, RANK)


def test_image_sample_loss_and_grads(tiny):
    """One still-image item (a 56 x 84 image, resized up to the (1, 8, 12)
    grid: 24 visual tokens) through `sample_loss(kind="image")` and through
    jax.value_and_grad of the JAX image composition (encode_image, the
    splice, the remat decoder): loss within 1e-4 relative, adapter
    gradients within 5e-2 x max (bf16 adapters and the bf16 merger, as in
    tests/test_torch_train.py::test_one_sample_loss_and_grads)."""
    cfg, jparams, tparams = tiny
    img = np.random.default_rng(3).integers(0, 256, (56, 84, 3),
                                            dtype=np.uint8)
    patches, grid = qwen_preprocess([img])
    assert grid == (1, 8, 12)
    item = {"conversations": [
        {"from": "human", "value": "<image>\nWhat is it?"},
        {"from": "gpt", "value": "A pattern."}]}
    ids, labels, (start, n_vis) = tft.preprocess_qwen_sample(
        item, make_byte_qwen_tokenizer(), cfg, grid, 160, kind="image")
    want_ids = jft.preprocess_qwen_sample(
        item, make_byte_qwen_tokenizer(), cfg, grid, 160, kind="image")
    np.testing.assert_array_equal(ids, want_ids[0])
    assert n_vis == 24 and (start, n_vis) == want_ids[2]
    pad = 160 - len(ids)
    seg = np.concatenate([np.zeros(len(ids), np.int32),
                          np.full(pad, -1, np.int32)])
    ids, labels = np.pad(ids, (0, pad)), np.pad(labels, (0, pad),
                                                 constant_values=-100)
    jl = _adapters(jparams, 4)

    def jloss(lora_params):
        lp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), lora_params)
        eff = jlora.lora_views(jparams, lp, alpha=ALPHA, rank=RANK)
        vis = jvq.encode_image(eff, cfg, jnp.asarray(patches), grid[1:])
        positions, _ = jvq.build_qwen_positions_dynamic(
            160, jnp.int32(start), n_vis, vis.visual_positions)
        embeds = jllm.embed_tokens(eff["llm"], jnp.asarray(ids)[None])
        embeds = jvq.splice_embeds_dynamic(embeds, vis.video_embeds,
                                           jnp.int32(start))
        h, _ = jllm.decoder_forward(eff["llm"], cfg.llm, embeds, positions,
                                    segment_ids=jnp.asarray(seg)[None],
                                    remat=True)
        return jllm.cross_entropy_loss(jllm.lm_head(eff["llm"], cfg.llm, h),
                                       jnp.asarray(labels)[None])
    jv, jg = jax.value_and_grad(jloss)(jl)
    tl = lora_from_numpy(_np(jl), "cpu")
    leaves = [(p, k, x.requires_grad_()) for p, ab in sorted(tl.items())
              for k, x in sorted(ab.items())]
    loss = tft.sample_loss(cfg, tparams, tl, torch.from_numpy(patches), grid,
                           torch.from_numpy(ids), torch.from_numpy(labels),
                           torch.from_numpy(seg), start, n_vis, None,
                           alpha=ALPHA, rank=RANK, kind="image")
    grads = torch.autograd.grad(loss, [x for *_, x in leaves])
    np.testing.assert_allclose(loss.item(), float(jv), rtol=1e-4)
    for (p, k, _), g in zip(leaves, grads):
        assert g.abs().max() > 0, f"{p}/{k}"
        _close(g, jg[p][k], 5e-2, f"{p}/{k}")


def test_run_training_with_image_items_matches_jax(tmp_path, tiny):
    """`run_training --dry-run` over one video and one image item (two
    buckets: the image's frame rung 0) with the JAX run's parameters,
    adapters and k-means draws carried across: both steps' losses within
    1e-4 relative of the JAX run's, one step in each bucket."""
    import json
    cfg, jparams, tparams = tiny
    data_path, video_dir = tft.build_synthetic_dataset(
        str(tmp_path / "data"), n_items=1, n_frames=8, n_images=1)
    with open(data_path) as f:
        assert [("image" in it) for it in json.load(f)] == [False, True]
    dry = ["--dry-run", "--data-path", data_path, "--video-dir", video_dir,
           "--max-steps", "2", "--grad-accum", "1", "--max-frames", "8",
           "--frame-bucket", "8", "--max-len", "128", "--max-pixels",
           str(56 * 56), "--lora-rank", str(RANK), "--lora-alpha",
           str(ALPHA), "--learning-rate", "5e-3", "--save-steps", "1"]
    jres = jft.run_training(jft.make_parser().parse_args(
        dry + ["--output-dir", str(tmp_path / "jax")]))
    B = len(jax.devices())

    def draws(step, micro, sample, n):
        _, sub = jax.random.split(jax.random.PRNGKey(step))
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.split(sub, B)[sample], (n,))))

    jl = jlora.init_lora_params(jax.random.PRNGKey(1), jparams, rank=RANK,
                                targets=jlora.QWEN_TARGETS)
    tres = tft.run_training(
        tft.make_parser().parse_args(dry + [
            "--output-dir", str(tmp_path / "torch"), "--device", "cpu",
            "--batch-size", str(B)]),
        cfg=cfg, params=tparams, lora=lora_from_numpy(_np(jl), "cpu"),
        kmeans_draws=draws)
    np.testing.assert_allclose(tres["losses"], jres["losses"], rtol=1e-4)
    lines = [json.loads(s) for s in open(tmp_path / "torch" /
                                          "scalars.jsonl")]
    assert sorted(r["bucket"].split("x")[-1] for r in lines) == ["0f", "8f"]
