"""The port's LLaVA converters, exporters and loaders held against the JAX
package's on the same shards, on the tiny LLaVA config.

The converters and exporters move, transpose and reshape tensors and cast
them once: in f32 and in bf16 every leaf must equal JAX's bit for bit, and
export-then-convert is the identity. `load_llava_checkpoint` and the three
branches of `load_pretrained_model` (full, projector-only over a base,
LoRA over a base) read checkpoint directories the port wrote and must give
JAX's trees (the LoRA merge sums in f32 on both sides: 1e-6). Last, CLIP
converted from an HF `CLIPVisionModel` (built offline from a config, as
tests/test_hf_parity.py builds it) encodes as HF does.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_vstream_tpu.core.config import tiny_llava_config as jax_cfg
from flash_vstream_tpu.models.vstream_llava import init_llava_params
from flash_vstream_tpu.weights import convert as jconv
from flash_vstream_tpu.weights import export as jexp
from flash_vstream_tpu_torch.core.config import VitConfig, tiny_llava_config
from flash_vstream_tpu_torch.models.clip_vit import clip_encode
from flash_vstream_tpu_torch.weights import convert as tconv
from flash_vstream_tpu_torch.weights import export as texp
from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy

torch.set_num_threads(1)
CFG = tiny_llava_config()


@pytest.fixture(scope="module")
def jparams():
    return init_llava_params(jax.random.PRNGKey(0), jax_cfg())


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def sd(jparams):
    """The JAX export of the tree: numpy shards, and the same as tensors."""
    np_sd = jexp.export_llava_checkpoint(jparams, jax_cfg())
    return np_sd, {k: torch.from_numpy(np.array(v)) for k, v in np_sd.items()}


def _bits(x):
    """A leaf's raw bytes as an integer array, whatever its framework."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy().view(np.uint8)
    x = np.asarray(x)
    return np.ascontiguousarray(x).view(np.uint8)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        names = getattr(tree, "_fields", range(len(tree)))
        for n, v in zip(names, tree):
            yield from _leaves(v, f"{path}/{n}")
    else:
        yield path, tree


def assert_bit_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for k in g:
        assert tuple(g[k].shape) == tuple(np.shape(w[k])), k
        np.testing.assert_array_equal(_bits(g[k]), _bits(w[k]), err_msg=k)


def assert_sd_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k].shape) == tuple(np.shape(want[k])), k
        np.testing.assert_array_equal(_bits(got[k].contiguous()),
                                      _bits(want[k]), err_msg=k)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_converters_match_jax_bit_for_bit(sd, dtype):
    np_sd, t_sd = sd
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    pre = "model.vision_tower.vision_tower."
    jv = {k[len(pre):]: v for k, v in np_sd.items() if k.startswith(pre)}
    tv = {k[len(pre):]: v for k, v in t_sd.items() if k.startswith(pre)}
    kw = dict(dtype=td, device="cpu")
    assert_bit_equal(tconv.convert_clip_vit(tv, CFG.vit, **kw),
                     jconv.convert_clip_vit(jv, jax_cfg().vit, dtype=jd))
    assert_bit_equal(tconv.convert_projector(t_sd, **kw),
                     jconv.convert_projector(np_sd, dtype=jd))
    assert_bit_equal(tconv.convert_ntm(t_sd, **kw),
                     jconv.convert_ntm(np_sd, dtype=jd))
    assert_bit_equal(tconv.convert_llama(t_sd, CFG.llm, **kw),
                     jconv.convert_llama(np_sd, jax_cfg().llm, dtype=jd))


def test_bare_linear_projector_and_missing_keys():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(8, 4)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    np_sd = {"model.mm_projector.weight": w, "model.mm_projector.bias": b}
    t_sd = {k: torch.from_numpy(v) for k, v in np_sd.items()}
    got = tconv.convert_projector(t_sd, device="cpu")
    assert_bit_equal(got, jconv.convert_projector(np_sd))
    assert_sd_equal(texp.export_projector(got), jexp.export_projector(
        jconv.convert_projector(np_sd)))
    with pytest.raises(KeyError, match="no projector"):
        tconv.convert_projector({}, device="cpu")


def test_exporters_match_jax_bit_for_bit(jparams, tparams):
    assert_sd_equal(texp.export_llava_checkpoint(tparams, CFG),
                    jexp.export_llava_checkpoint(jparams, jax_cfg()))
    assert_sd_equal(texp.export_clip_vit(tparams["vit"], CFG.vit),
                    jexp.export_clip_vit(jparams["vit"], jax_cfg().vit))
    assert_sd_equal(texp.export_ntm(tparams["ntm"]),
                    jexp.export_ntm(jparams["ntm"]))


def test_export_then_convert_is_the_identity(tparams):
    sd = {k: v.contiguous() for k, v in
          texp.export_llava_checkpoint(tparams, CFG).items()}
    pre = "model.vision_tower.vision_tower."
    back = {
        "vit": tconv.convert_clip_vit(
            {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)},
            CFG.vit, device="cpu"),
        "projector": tconv.convert_projector(sd, device="cpu"),
        "ntm": tconv.convert_ntm(sd, device="cpu"),
        "llm": tconv.convert_llama(sd, CFG.llm, device="cpu"),
    }
    assert_bit_equal(back, tparams)


@pytest.fixture(scope="module")
def base_ckpt(tmp_path_factory, tparams):
    """A LLaVA checkpoint directory the port wrote (two shards)."""
    base = str(tmp_path_factory.mktemp("llava") / "base")
    names = texp.save_hf_checkpoint(
        base, texp.export_llava_checkpoint(tparams, CFG),
        max_shard_bytes=400_000)
    assert len(names) >= 2
    return base


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_load_llava_checkpoint_matches_jax(base_ckpt, tparams, dtype):
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    got = tconv.load_llava_checkpoint(base_ckpt, CFG, dtype=td, device="cpu")
    assert_bit_equal(got, jconv.load_llava_checkpoint(base_ckpt, jax_cfg(),
                                                      dtype=jd))
    if dtype == "f32":
        assert_bit_equal(got, tparams)
        assert_bit_equal(tconv.load_pretrained_model(base_ckpt, CFG,
                                                     device="cpu"), tparams)


def test_load_llava_checkpoint_without_tower_raises(tmp_path, tparams):
    sd = {k: v for k, v in texp.export_llava_checkpoint(tparams, CFG).items()
          if "vision_tower" not in k}
    texp.save_hf_checkpoint(str(tmp_path / "c"), sd)
    with pytest.raises(FileNotFoundError, match="vision tower"):
        tconv.load_llava_checkpoint(str(tmp_path / "c"), CFG, device="cpu")


def test_projector_only_branch_matches_jax(base_ckpt, tparams, tmp_path):
    """Stage-1 artifact: mm_projector.bin over a base (builder.py:88-95)."""
    stage1 = str(tmp_path / "vstream-pretrain")
    os.makedirs(stage1)
    rng = np.random.default_rng(1)
    proj = {}
    for i, lp in enumerate(tparams["projector"]["layers"]):
        proj[f"model.mm_projector.{2 * i}.weight"] = torch.from_numpy(
            rng.normal(size=tuple(lp["w"].T.shape)).astype(np.float32))
        proj[f"model.mm_projector.{2 * i}.bias"] = torch.from_numpy(
            rng.normal(size=tuple(lp["b"].shape)).astype(np.float32))
    torch.save(proj, os.path.join(stage1, "mm_projector.bin"))
    got = tconv.load_pretrained_model(stage1, CFG, model_base=base_ckpt,
                                      device="cpu")
    assert_bit_equal(got, jconv.load_pretrained_model(
        stage1, jax_cfg(), model_base=base_ckpt))
    assert torch.equal(got["projector"]["layers"][0]["w"],
                       proj["model.mm_projector.0.weight"].T)
    assert_bit_equal(got["llm"], tparams["llm"])
    with pytest.raises(FileNotFoundError, match="mm_projector.bin"):
        tconv.load_pretrained_model(str(tmp_path), CFG, model_base=base_ckpt,
                                    device="cpu")


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_lora_branch_matches_jax(base_ckpt, tparams, tmp_path, fmt):
    """LoRA: non_lora_trainables.bin laid over the base (NTM and the
    embedding rows under PEFT's prefixes), the adapter merged with
    lora_alpha / r from adapter_config.json (builder.py:52-86)."""
    lora = str(tmp_path / "vstream-7b-lora")
    os.makedirs(lora)
    rank, alpha = 2, 8
    D = CFG.llm.hidden_size
    rng = np.random.default_rng(2)
    A = rng.normal(size=(rank, D)).astype(np.float32)
    B = rng.normal(size=(D, rank)).astype(np.float32)
    pre = "base_model.model.model.layers.{}.self_attn.q_proj.lora_{}.weight"
    adapter = {pre.format(0, "A"): torch.from_numpy(A),
               pre.format(0, "B"): torch.from_numpy(B),
               pre.format(1, "A"): torch.from_numpy(A * 0.5),
               pre.format(1, "B"): torch.from_numpy(B)}
    if fmt == "bin":
        torch.save(adapter, os.path.join(lora, "adapter_model.bin"))
    else:
        from flash_vstream_tpu_torch.weights.safetensors_io import save_file
        save_file(adapter, os.path.join(lora, "adapter_model.safetensors"))
    with open(os.path.join(lora, "adapter_config.json"), "w") as f:
        json.dump({"r": rank, "lora_alpha": alpha}, f)
    nlt = {f"base_model.model.{k}": v.contiguous() * 1.5 for k, v in
           texp.export_ntm(tparams["ntm"]).items()}
    nlt["base_model.model.model.embed_tokens.weight"] = torch.from_numpy(
        rng.normal(size=(3, D)).astype(np.float32))
    torch.save(nlt, os.path.join(lora, "non_lora_trainables.bin"))
    got = tconv.load_pretrained_model(lora, CFG, model_base=base_ckpt,
                                      tokenizer_len=CFG.llm.vocab_size + 2,
                                      device="cpu")
    want = jconv.load_pretrained_model(lora, jax_cfg(), model_base=base_ckpt,
                                       tokenizer_len=CFG.llm.vocab_size + 2)
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for k in g:
        np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), rtol=0,
                                   atol=1e-6, err_msg=k)
    assert got["llm"]["embed"].shape[0] == CFG.llm.vocab_size + 2
    assert torch.equal(got["ntm"].wq, tparams["ntm"].wq * 1.5)
    wq = got["llm"]["layers"]["attn"]["wq"]["w"]
    np.testing.assert_allclose(
        wq[0].numpy(), tparams["llm"]["layers"]["attn"]["wq"]["w"][0].numpy()
        + (alpha / rank) * (B @ A).T, atol=1e-5)


def test_peft_prefixes_and_torch_bin(tmp_path):
    sd = {"base_model.model.model.x": torch.ones(2, dtype=torch.bfloat16),
          "model.model.y": torch.zeros(1), "model.z": torch.ones(1)}
    assert sorted(tconv._strip_peft_prefixes(sd)) == ["model.x", "model.y",
                                                      "model.z"]
    assert sorted(tconv._strip_peft_prefixes(sd)) == sorted(
        jconv._strip_peft_prefixes(sd))
    path = str(tmp_path / "w.bin")
    torch.save(sd, path)
    got = tconv.load_torch_bin(path)
    want = jconv.load_torch_bin(path)
    for k in sd:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_clip_matches_hf_clip_vision_model():
    """convert_clip_vit + clip_encode against HF's CLIPVisionModel: the
    select_layer -2 hidden state without CLS (2e-3, the JAX test's
    tolerance: f32 over four layers in other orders)."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=4,
        num_attention_heads=4, image_size=56, patch_size=14, num_channels=3)
    torch.manual_seed(0)
    hf = transformers.CLIPVisionModel(hf_cfg).eval()
    cfg = VitConfig(hidden_size=32, intermediate_size=64, num_layers=4,
                    num_heads=4, patch_size=14, image_size=56,
                    select_layer=-2, hidden_act="quick_gelu")
    params = tconv.convert_clip_vit(
        {k: v.detach() for k, v in hf.state_dict().items()}, cfg,
        device="cpu")
    imgs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 3, 56, 56)).astype(np.float32))
    with torch.no_grad():
        want = hf(imgs, output_hidden_states=True).hidden_states[-2][:, 1:]
        got = clip_encode(params, cfg, imgs)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)
    # and back: the export is HF's state dict
    back = texp.export_clip_vit(params, cfg)
    for k, v in hf.state_dict().items():
        if k in back:
            assert torch.equal(back[k].contiguous(), v), k
    assert "vision_model.embeddings.position_ids" not in back
