"""The port's safetensors reader and writer, its Qwen checkpoint loaders
and exporters, and `qwen_config_from_hf`, against the `safetensors`
package, the JAX package and transformers' Qwen2-VL, on the CPU.

Files and converted trees are compared bit for bit (the conversions only
transpose, split, stack and cast). The HF model built offline is held at
2e-3 on its logits and 5e-3 on its vision tower's output, the limits of
tests/test_hf_parity.py for the JAX package (f32, two layers: attention
and norms summed in another order).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_vstream_tpu.core.config import tiny_qwen_config as jax_tiny
from flash_vstream_tpu.models.vstream_qwen import init_qwen_params
from flash_vstream_tpu.weights import convert as jconvert
from flash_vstream_tpu.weights import export as jexport
from flash_vstream_tpu_torch.core.config import (VStreamQwenConfig,
                                                 tiny_qwen_config)
from flash_vstream_tpu_torch.weights import convert as tconvert
from flash_vstream_tpu_torch.weights import export as texport
from flash_vstream_tpu_torch.weights import safetensors_io as st
from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy

torch.set_num_threads(1)
CFG = tiny_qwen_config()


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _bits(x) -> np.ndarray:
    """A leaf's bytes as an integer array (bf16 included), for bit-equality."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def assert_trees_equal(got: dict, want: dict):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert tuple(g[k].shape) == tuple(np.shape(w[k])), k
        np.testing.assert_array_equal(_bits(g[k]), _bits(w[k]), err_msg=k)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """The tiny model's JAX params written by the JAX exporter (f32
    shards, through safetensors.numpy)."""
    path = str(tmp_path_factory.mktemp("jax_ckpt"))
    params = init_qwen_params(jax.random.PRNGKey(0), jax_tiny())
    sd = jexport.export_llama(params["llm"], jax_tiny().llm)
    sd.update(jexport.export_qwen_vit(params["vit"], jax_tiny().vit))
    jexport.save_hf_checkpoint(path, sd)
    return path, params, sd


# ---------------------------------------------------------------------------
# the file format
# ---------------------------------------------------------------------------

DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.int64,
          torch.int32, torch.int8, torch.uint8, torch.bool]


def _tensor(dtype, shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=g) * 100).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -2**40), min(info.max, 2**40), shape,
                         generator=g, dtype=torch.int64).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_reads_safetensors_files(tmp_path, dtype):
    """Files of `safetensors.torch.save_file` (odd shapes, a scalar, an
    empty tensor, mixed dtypes so offsets are not all aligned to the
    widest) read back bit for bit."""
    from safetensors.torch import save_file
    tensors = {"a": _tensor(dtype, (3, 5, 7)), "scalar": _tensor(dtype, ()),
               "empty": _tensor(dtype, (0, 4)), "byte": _tensor(torch.uint8, (3,)),
               "wide": _tensor(torch.float32, (2, 3), seed=1)}
    save_file(tensors, str(tmp_path / "x.safetensors"), metadata={"k": "v"})
    got = st.load_file(str(tmp_path / "x.safetensors"))
    assert sorted(got) == sorted(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape
        assert torch.equal(got[k], t), k


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_writes_safetensors_files(tmp_path, dtype):
    """`safetensors.torch.load_file` reads the port's files bit for bit,
    non-contiguous tensors (a transpose, a slice) included; so does the
    port's reader."""
    from safetensors.torch import load_file
    base = _tensor(dtype, (6, 9))
    tensors = {"t": base.T, "row": base[2], "scalar": _tensor(dtype, ()),
               "mixed": _tensor(torch.float32, (5,), seed=2),
               "b": _tensor(torch.uint8, (3,), seed=3)}
    n = st.save_file(tensors, str(tmp_path / "y.safetensors"))
    assert n == os.path.getsize(tmp_path / "y.safetensors")
    for reader in (load_file, st.load_file):
        got = reader(str(tmp_path / "y.safetensors"))
        for k, t in tensors.items():
            assert got[k].dtype == t.dtype and torch.equal(got[k], t), k


def test_refuses_bad_files(tmp_path):
    with pytest.raises(ValueError, match="dtype"):
        st.save_file({"c": torch.zeros(2, dtype=torch.float64)},
                     str(tmp_path / "c.safetensors"))
    from safetensors.torch import save_file
    save_file({"d": torch.zeros(2, dtype=torch.float64)},
              str(tmp_path / "d.safetensors"))
    with pytest.raises(ValueError, match="F64"):
        st.load_file(str(tmp_path / "d.safetensors"))
    p = str(tmp_path / "t.safetensors")
    st.save_file({"x": torch.arange(8, dtype=torch.int32)}, p)
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) - 4)
    with pytest.raises(ValueError, match="data_offsets"):
        st.load_file(p)


def test_sharded_checkpoint(tmp_path):
    """Shards of at most max_shard_bytes, each read by the `safetensors`
    package, with the index; the directory loads whole."""
    from safetensors.torch import load_file
    sd = {f"w{i}": _tensor(torch.bfloat16, (64, 32), seed=i)
          for i in range(5)}                                  # 4 KiB each
    names = texport.save_hf_checkpoint(str(tmp_path), sd,
                                       config={"x": 1},
                                       max_shard_bytes=9000)
    assert names == [f"model-0000{i}-of-00003.safetensors"
                     for i in (1, 2, 3)]
    index = json.load(open(tmp_path / "model.safetensors.index.json"))
    assert index["metadata"]["total_size"] == 5 * 4096
    seen = {}
    for name in names:
        part = load_file(str(tmp_path / name))
        assert sum(t.numel() * 2 for t in part.values()) <= 9000
        seen.update(part)
        assert all(index["weight_map"][k] == name for k in part)
    assert sorted(seen) == sorted(sd)
    whole = tconvert.load_safetensors_dir(str(tmp_path))
    for k, t in sd.items():
        assert torch.equal(seen[k], t) and torch.equal(whole[k], t)
    assert json.load(open(tmp_path / "config.json")) == {"x": 1}
    os.makedirs(tmp_path / "none")
    with pytest.raises(FileNotFoundError):
        tconvert.load_safetensors_dir(str(tmp_path / "none"))


# ---------------------------------------------------------------------------
# converters and exporters against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_qwen_checkpoint_matches_jax(jax_ckpt, dtype):
    path, _, _ = jax_ckpt
    want = jconvert.load_qwen_checkpoint(path, jax_tiny(),
                                         dtype=getattr(jnp, dtype))
    got = tconvert.load_qwen_checkpoint(path, CFG,
                                        dtype=getattr(torch, dtype),
                                        device="cpu")
    assert_trees_equal(got, jax.tree.map(np.asarray, want))


def test_converters_match_jax(jax_ckpt):
    """convert_llama and convert_qwen_vit on one in-memory state dict (the
    HF >= 4.52 layout: model.language_model., model.visual.)."""
    _, params, sd = jax_ckpt
    renamed = {("model.language_model." + k[len("model."):]
                if k.startswith("model.") else
                "model.visual." + k[len("visual."):]
                if k.startswith("visual.") else k): v for k, v in sd.items()}
    tsd = {k: torch.from_numpy(np.asarray(v)) for k, v in renamed.items()}
    assert_trees_equal(tconvert.convert_llama(tsd, CFG.llm, device="cpu"),
                       jax.tree.map(np.asarray, jconvert.convert_llama(
                           renamed, jax_tiny().llm)))
    assert_trees_equal(tconvert.convert_qwen_vit(tsd, CFG.vit, device="cpu"),
                       jax.tree.map(np.asarray, jconvert.convert_qwen_vit(
                           renamed, jax_tiny().vit)))
    assert tconvert.detect_prefix(tsd, "patch_embed.proj.weight",
                                  ("visual.", "model.visual.")) \
        == "model.visual."
    with pytest.raises(KeyError):
        tconvert.detect_prefix(tsd, "nope", ("model.",))


def test_export_matches_jax_and_round_trips(jax_ckpt):
    """The port's exporters give JAX's state dict; export then convert is
    the identity on the tree."""
    _, params, want = jax_ckpt
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    got = texport.export_llama(tparams["llm"], CFG.llm)
    got.update(texport.export_qwen_vit(tparams["vit"], CFG.vit))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    back = {"vit": tconvert.convert_qwen_vit(got, CFG.vit, device="cpu"),
            "llm": tconvert.convert_llama(got, CFG.llm, device="cpu")}
    assert_trees_equal(back, tparams)


def test_resize_token_embeddings_matches_jax(jax_ckpt):
    _, params, _ = jax_ckpt
    tllm = params_from_numpy(jax.tree.map(np.asarray, params["llm"]), "cpu")
    tllm["lm_head"] = tllm["embed"].T.contiguous() * 0.5
    jllm = dict(params["llm"], lm_head=jnp.asarray(tllm["lm_head"].numpy()))
    V = tllm["embed"].shape[0]
    got = tconvert.resize_token_embeddings(tllm, V + 3)
    want = jconvert.resize_token_embeddings(jllm, V + 3)
    for k in ("embed", "lm_head"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
    assert got["embed"].shape == (V + 3, CFG.llm.hidden_size)
    assert tconvert.resize_token_embeddings(tllm, V) is tllm


# ---------------------------------------------------------------------------
# config.json
# ---------------------------------------------------------------------------

def _cfg_dict(cfg):
    d = dataclasses.asdict(cfg)
    d["vit"].pop("image_size")        # the one documented difference
    return d


@pytest.mark.parametrize("nested", [False, True])
def test_qwen_config_from_hf_matches_jax(tmp_path, nested):
    """Field by field JAX's, on the flat and the `text_config` layouts,
    but for vit.image_size: 0 in the port (Qwen2-VL's variable
    resolution), VitConfig's 224 in JAX."""
    d = texport.hf_qwen_config(VStreamQwenConfig())
    d["vision_config"]["flash_memory_config"] = {
        "flash_memory_temporal_length": 16,
        "flash_memory_temporal_method": "kmeans_ordered",
        "flash_memory_temporal_poolsize": 2,
        "flash_memory_spatial_length": 8,
        "flash_memory_spatial_method": "klarge_retrieve"}
    if nested:
        keys = ("vocab_size", "hidden_size", "intermediate_size",
                "num_hidden_layers", "num_attention_heads",
                "num_key_value_heads", "max_position_embeddings",
                "rms_norm_eps", "rope_theta", "rope_scaling")
        d["text_config"] = {k: d.pop(k) for k in keys}
    with open(tmp_path / "config.json", "w") as f:
        json.dump(d, f)
    got = tconvert.qwen_config_from_hf(str(tmp_path))
    want = jconvert.qwen_config_from_hf(d)
    assert _cfg_dict(got) == _cfg_dict(want)
    assert got.vit.image_size == 0 and want.vit.image_size == 224
    assert got.flash_memory.csm_grid_len == 8


def test_hf_qwen_config_round_trip():
    """hf_qwen_config is read back to the config it was written from: the
    7B one whole, the tiny one but for max_seq_len."""
    assert tconvert.qwen_config_from_hf(
        texport.hf_qwen_config(VStreamQwenConfig())) == VStreamQwenConfig()
    back = tconvert.qwen_config_from_hf(texport.hf_qwen_config(CFG))
    assert back == CFG.replace(max_seq_len=back.max_seq_len)


# ---------------------------------------------------------------------------
# a checkpoint written by transformers
# ---------------------------------------------------------------------------

def test_hf_save_pretrained_loads(tmp_path, rng):
    """A tiny Qwen2VLForConditionalGeneration built offline and written
    with save_pretrained: its config and weights load through the port, and
    the decoder's logits (M-RoPE positions) and the vision tower's output
    match the HF model's."""
    from transformers import Qwen2VLForConditionalGeneration
    from transformers.models.qwen2_vl.configuration_qwen2_vl import (
        Qwen2VLConfig)
    from flash_vstream_tpu_torch.models.llm import (decoder_forward,
                                                    embed_tokens, lm_head)
    from flash_vstream_tpu_torch.models.qwen2_vit import (
        grid_positions, grid_segments, patch_merger, qwen_vit_blocks)
    hf_cfg = Qwen2VLConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-6, rope_theta=10000.0,
        tie_word_embeddings=False,
        rope_scaling={"type": "mrope", "mrope_section": [2, 1, 1]},
        vision_config={"embed_dim": 32, "hidden_size": 32, "depth": 2,
                       "num_heads": 4, "in_channels": 3, "patch_size": 14,
                       "spatial_merge_size": 2, "temporal_patch_size": 2,
                       "mlp_ratio": 2})
    torch.manual_seed(0)
    hf = Qwen2VLForConditionalGeneration(hf_cfg).eval()
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    cfg = tconvert.qwen_config_from_hf(str(tmp_path))
    assert (cfg.llm.hidden_size, cfg.vit.intermediate_size,
            cfg.llm.mrope_sections) == (32, 64, (2, 1, 1))
    params = tconvert.load_qwen_checkpoint(str(tmp_path), cfg, device="cpu")

    ids = rng.integers(0, 128, size=(1, 10))
    pos3 = np.stack([np.arange(10), np.arange(10) // 2, np.arange(10) % 3])
    with torch.no_grad():
        h = hf.model.language_model(
            input_ids=torch.from_numpy(ids),
            position_ids=torch.from_numpy(pos3[:, None, :])).last_hidden_state
        want = hf.lm_head(h).numpy()
        llm = params["llm"]
        got = lm_head(llm, cfg.llm, decoder_forward(
            llm, cfg.llm, embed_tokens(llm, torch.from_numpy(ids)),
            torch.from_numpy(pos3)[:, None, :])).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)

    grid = (2, 4, 4)
    patches = rng.normal(size=(32, 3 * 2 * 14 * 14)).astype(np.float32)
    visual = hf.model.visual if hasattr(hf.model, "visual") else hf.visual
    with torch.no_grad():
        want = visual(torch.from_numpy(patches),
                      grid_thw=torch.tensor([grid])).numpy()
        hidden = qwen_vit_blocks(params["vit"], cfg.vit,
                                 torch.from_numpy(patches),
                                 grid_positions([grid]), grid_segments([grid]))
        got = patch_merger(params["vit"], hidden).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)
