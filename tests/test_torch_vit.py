"""The ingest front and the Qwen2-VL ViT of the port against JAX on a
112x112 clip, in f32 on the CPU: atol 1e-5 for the preprocessing ops, 1e-4
for the ViT blocks and the PatchMerger (layers of f32 matmuls summed in a
different order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_vstream_tpu.core.config import tiny_qwen_config
from flash_vstream_tpu.models import qwen2_vit as jv
from flash_vstream_tpu.ops.pooling import qwen_temporal_pool as jax_pool
from flash_vstream_tpu.preprocess.image import (
    qwen_device_preprocess as jax_preprocess)
from flash_vstream_tpu_torch.models import qwen2_vit as tv
from flash_vstream_tpu_torch.ops.pooling import qwen_temporal_pool
from flash_vstream_tpu_torch.preprocess.image import qwen_device_preprocess
from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy

torch.set_num_threads(1)
GRID = (1, 8, 8)          # one frame pair at 112x112


@pytest.fixture(scope="module")
def clip():
    return np.random.default_rng(0).integers(0, 256, size=(2, 112, 112, 3),
                                             dtype=np.uint8)


@pytest.fixture(scope="module")
def vit():
    cfg = tiny_qwen_config().vit
    params = jv.init_qwen_vit_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def test_device_preprocess_f32(clip):
    want = jax_preprocess(jnp.asarray(clip), dtype=jnp.float32)
    got = qwen_device_preprocess(torch.from_numpy(clip), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_device_preprocess_bf16(clip):
    want = np.array(jax_preprocess(jnp.asarray(clip)), np.float32)
    got = qwen_device_preprocess(torch.from_numpy(clip)).float().numpy()
    # both round the same f32 values to bf16; allow one bf16 ulp at |x|~2
    np.testing.assert_allclose(got, want, atol=1.6e-2)
    assert (got == want).mean() > 0.999


def test_temporal_pool(clip):
    patches = np.array(jax_preprocess(jnp.asarray(clip), dtype=jnp.float32))
    want, wgrid = jax_pool(jnp.asarray(patches), GRID)
    got, grid = qwen_temporal_pool(torch.from_numpy(patches), GRID)
    assert grid == wgrid == (1, 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_grid_positions_and_segments():
    grids = [(2, 8, 8), (1, 4, 6)]
    np.testing.assert_array_equal(tv.grid_positions(grids),
                                  jv.grid_positions(grids))
    np.testing.assert_array_equal(tv.grid_segments(grids),
                                  jv.grid_segments(grids))


def test_vit_blocks_frames(clip, vit):
    cfg, jparams, tparams = vit
    patches = np.array(jax_preprocess(jnp.asarray(clip), dtype=jnp.float32))
    small, _ = jax_pool(jnp.asarray(patches), GRID)
    allp = np.concatenate([patches, np.asarray(small)])
    kw = dict(t_full=1, hw_full=(8, 8), t_small=1, hw_small=(4, 4))
    want = jv.qwen_vit_blocks_frames(jparams, cfg, jnp.asarray(allp), **kw)
    got = tv.qwen_vit_blocks_frames(tparams, cfg, torch.from_numpy(allp), **kw)
    assert got.shape == (80, cfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # the module form runs the same function
    module = tv.QwenVisionTransformer(cfg, tparams)
    torch.testing.assert_close(module(torch.from_numpy(allp), **kw), got)


def test_patch_merger(vit):
    cfg, jparams, tparams = vit
    x = np.random.default_rng(1).normal(size=(64, cfg.hidden_size))
    x = x.astype(np.float32)
    want = jv.patch_merger(jparams, jnp.asarray(x))
    got = tv.patch_merger(tparams, torch.from_numpy(x))
    assert got.shape == (16, cfg.merger_out_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    merger = tv.PatchMerger(tparams["merger"])
    torch.testing.assert_close(merger(torch.from_numpy(x)), got)
