"""The PyTorch port's streaming slice as a whole, held against the JAX
session: one parameter tree, the same frames, the same k-means init draws.

Both sessions run their default bf16 path (bf16 patch stream and ViT, bf16
frame banks), so the published snapshots agree to bf16 rounding, not to f32
precision: the two frameworks round bf16 matmuls on the CPU in different
places. The integer parts (frame positions, cluster timestamps) must be
equal, and the greedy answers must be the same token ids.
"""
import jax
import numpy as np
import pytest
import torch

from flash_vstream_tpu.core.config import tiny_qwen_config
from flash_vstream_tpu.models.vstream_qwen import init_qwen_params as jax_init
from flash_vstream_tpu.preprocess.qwen_processor import (
    make_byte_qwen_tokenizer as jax_tokenizer)
from flash_vstream_tpu.runtime.generation import (
    GenerationConfig as JaxGenerationConfig)
from flash_vstream_tpu.runtime.streaming import (
    QwenStreamSession as JaxQwenStreamSession)
from flash_vstream_tpu_torch.models.vstream_qwen import VStreamQwen
from flash_vstream_tpu_torch.preprocess.qwen_processor import (
    make_byte_qwen_tokenizer)
from flash_vstream_tpu_torch.runtime.generation import GenerationConfig
from flash_vstream_tpu_torch.runtime.streaming import QwenStreamSession, bucket_up
from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy

torch.set_num_threads(1)

# features reach |x| ~ 5, where one bf16 ulp is 0.031; the sessions differ
# by at most 0.039 (one ulp plus the f32 noise under it)
FEATURE_ATOL = 5e-2
N_INGESTS = 7
KW = dict(frame_hw=(112, 112), clip_size=2, bank_size=16, max_len=512)


def _jax_scores(step, n):
    return torch.from_numpy(np.array(
        jax.random.uniform(jax.random.PRNGKey(step), (n,))))


@pytest.fixture(scope="module")
def sessions():
    cfg = tiny_qwen_config()
    params = jax_init(jax.random.PRNGKey(0), cfg)
    jsess = JaxQwenStreamSession(params, cfg, jax_tokenizer(), **KW)
    model = VStreamQwen(cfg, params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"))
    tsess = QwenStreamSession(model, make_byte_qwen_tokenizer(), **KW)
    tsess._init_scores = _jax_scores     # the JAX session's k-means draws
    rng = np.random.default_rng(0)
    # a few distinct scenes with small noise, so clustering has structure
    scenes = rng.integers(0, 256, size=(3, 112, 112, 3))
    snaps = []
    for i in range(N_INGESTS):
        frames = [np.clip(scenes[(i // 2) % 3] + rng.integers(-64, 65, scenes[0].shape),
                          0, 255).astype(np.uint8) for _ in range(2)]
        jsess.ingest_frames(frames)
        tsess.ingest_frames(frames)
        snaps.append((jax.tree.map(np.asarray, jsess._published[0]),
                      [x.float().numpy() if x.is_floating_point() else x.numpy()
                       for x in tsess._published[0]]))
    return jsess, tsess, snaps


def test_snapshot_after_every_ingest(sessions):
    jsess, tsess, snaps = sessions
    for i, (want, got) in enumerate(snaps):
        spa_pos, tem_pos, spa_x, tem_x = want
        np.testing.assert_array_equal(got[0], spa_pos, err_msg=f"ingest {i}")
        np.testing.assert_array_equal(got[1], tem_pos, err_msg=f"ingest {i}")
        np.testing.assert_allclose(got[2].astype(np.float32),
                                   np.asarray(spa_x, np.float32),
                                   atol=FEATURE_ATOL, err_msg=f"ingest {i}")
        np.testing.assert_allclose(got[3], tem_x, atol=FEATURE_ATOL,
                                   err_msg=f"ingest {i}")
    assert tsess.n_frames == jsess.n_frames == N_INGESTS


def test_memory_saturates(sessions):
    _, tsess, _ = sessions
    fm = tsess.cfg.flash_memory
    # more frame pairs than clusters: CSM clustering and DAM retrieval ran
    assert tsess.n_frames > fm.csm_grid_len > fm.dam_grid_len
    assert bool(tsess.state.tem_valid.all())


def test_greedy_answer_token_ids(sessions):
    jsess, tsess, _ = sessions
    q = "What happens in the video?"
    jgen = JaxGenerationConfig(max_new_tokens=8, eos_token_ids=())
    gen = GenerationConfig(max_new_tokens=8, eos_token_ids=())
    snap, n = jsess._published
    want = jsess._answer_fused(snap, n, q, jgen)
    tsnap, tn = tsess._published
    got = tsess.answer_tokens(tsnap, tn, q, gen)
    assert len(got) == 8
    assert got == want
    assert isinstance(tsess.answer(q, gen), str)


@pytest.mark.parametrize("real,cap,want", [(1, 30, 7), (8, 30, 15),
                                           (16, 30, 30), (30, 30, 30),
                                           (3, 60, 15), (61, 60, 60)])
def test_bucket_up(real, cap, want):
    from flash_vstream_tpu.runtime.streaming import bucket_up as jax_bucket_up
    assert bucket_up(real, cap) == jax_bucket_up(real, cap) == want
