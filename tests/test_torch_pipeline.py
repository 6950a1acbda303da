"""The port's offline QA pieces and `QwenPipeline` against the JAX package
on the tiny config, f32 weights on the CPU.

Prompt ids, rope positions and grid indices are integers and must be
equal. The varlen ViT and `encode_image` take f32 patches here and agree
to 1e-4 x max (two layers of f32 matmuls summed in another order).

Both pipelines normalize frames into a bf16 patch stream, so their ViTs
compute in bf16 even over f32 weights, and XLA fuses the bf16 elementwise
ops (quick_gelu's 1.702 x, exp, add, divide) where torch rounds after each:
over the default stream the visual embeddings agree to 5e-2 absolute
(features of |x| ~ 2-5, one bf16 ulp 0.016-0.031), the text embeddings and
positions exactly, and a greedy answer can part at a near tie of the
logits. The answers are therefore held with both patch streams in f32
(`f32_patches`: the one preprocessing call of each pipeline, patched in
the test), where every answer must be JAX's token ids, the port given
JAX's k-means init draws for PRNGKey(seed). The frames are scenes of
textures (each an exact pair and noisy ones) so that k-means and the DAM
retrieval decide by wide margins.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_vstream_tpu.core.config import tiny_qwen_config
from flash_vstream_tpu.models import flash_memory as jfm
from flash_vstream_tpu.models import qwen2_vit as jv
from flash_vstream_tpu.models import vstream_qwen as jvq
from flash_vstream_tpu.preprocess import qwen_processor as jqp
from flash_vstream_tpu.runtime.generation import GenerationConfig as JGen
from flash_vstream_tpu.runtime.pipeline import QwenPipeline as JPipeline
from flash_vstream_tpu_torch.models import flash_memory as tfm
from flash_vstream_tpu_torch.models import qwen2_vit as tv
from flash_vstream_tpu_torch.models import vstream_qwen as tvq
from flash_vstream_tpu_torch.preprocess import qwen_processor as tqp
from flash_vstream_tpu_torch.preprocess.video import SyntheticSource
from flash_vstream_tpu_torch.runtime.generation import GenerationConfig
from flash_vstream_tpu_torch.runtime.pipeline import QwenPipeline
from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy

torch.set_num_threads(1)
CFG = tiny_qwen_config()
VIS_ATOL = 5e-2
Q = "What happens in the video?"


def recording(tok):
    """`tok` with a `decode` that keeps the ids it was given in `tok.ids`:
    the JAX pipeline returns text, and the test compares token ids."""
    tok.ids, decode = [], tok.decode

    def record(ids, **kw):
        tok.ids.append([int(t) for t in ids])
        return decode(ids, **kw)
    tok.decode = record
    return tok


@pytest.fixture
def f32_patches(pipes, monkeypatch):
    """Both pipelines' patch streams in f32 (JAX's per-grid jit cache
    cleared, so no bf16 trace is reused)."""
    import functools
    from flash_vstream_tpu.preprocess import image as jimage
    from flash_vstream_tpu_torch.runtime import pipeline as tpipeline
    monkeypatch.setattr(jimage, "qwen_device_preprocess", functools.partial(
        jimage.qwen_device_preprocess, dtype=jnp.float32))
    monkeypatch.setattr(tpipeline, "qwen_device_preprocess",
                        functools.partial(tpipeline.qwen_device_preprocess,
                                          dtype=torch.float32))
    pipes[0]._encode_cache.clear()
    yield pipes
    pipes[0]._encode_cache.clear()


@pytest.fixture(scope="module")
def pipes():
    jparams = jvq.init_qwen_params(jax.random.PRNGKey(0), CFG)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jp = JPipeline(jparams, CFG, recording(jqp.make_byte_qwen_tokenizer()),
                   max_len=1024)
    tp = QwenPipeline(tparams, CFG, tqp.make_byte_qwen_tokenizer(),
                      max_len=1024)
    return jp, tp


def _scenes(seed, sizes, side=56):
    """Frame pairs in scenes of random textures: each scene an exact pair
    followed by noisy ones."""
    rng = np.random.default_rng(seed)
    frames = []
    for size in sizes:
        texture = rng.integers(0, 256, (side, side, 3))
        for j in range(size):
            f = texture + (rng.integers(-24, 25, texture.shape) if j else 0)
            frames += [f.clip(0, 255).astype(np.uint8)] * 2
    return frames


def _draws(seed):
    """JAX's k-means draws for PRNGKey(seed) as a draw function."""
    return lambda n: torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(seed), (n,))))


# ---------------------------------------------------------------------------
# grid index, rope positions, prompts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", [(2, 4, 6), (1, 8, 8), (3, 2, 2)])
def test_mm_grid_index(grid):
    np.testing.assert_array_equal(tvq.mm_grid_index(*grid),
                                  jvq.mm_grid_index(*grid))
    assert tvq.image_token_count(*grid[1:]) == jvq.image_token_count(
        *grid[1:])


def test_mm_rope_single_span_equals_qwen_rope():
    vp = np.stack([np.arange(4), np.zeros(4, np.int64), np.ones(4, np.int64)])
    ids = np.arange(20)
    want = jfm.qwen_rope_positions(ids, (5, 4), vp)
    got = tfm.qwen_rope_positions(ids, (5, 4), torch.from_numpy(vp))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    b_pos, b_delta = tfm.mm_rope_positions(ids, [(5, vp)])
    np.testing.assert_array_equal(b_pos, got[0])
    assert b_delta == got[1]


def test_mm_rope_two_spans_resume_rule():
    """Text after each span resumes at the running max + 1; the second
    span's block is offset by that index (the JAX test's numbers)."""
    img = tvq.mm_grid_index(1, 2, 2)        # 1 token, pos (0, 0, 0)
    vid = tvq.mm_grid_index(2, 2, 2)        # 2 tokens, t = 0, 1
    S = 3 + 1 + 2 + 2 + 4
    ids = np.arange(S)
    pos, delta = tfm.mm_rope_positions(ids, [(3, img), (6, vid)])
    want, wdelta = jfm.mm_rope_positions(ids, [(3, img), (6, vid)])
    np.testing.assert_array_equal(pos, want)
    assert delta == wdelta == int(pos.max()) + 1 - S
    np.testing.assert_array_equal(pos[:, 4:6], [[4, 5]] * 3)
    np.testing.assert_array_equal(pos[0, 6:8], [6, 7])
    np.testing.assert_array_equal(pos[:, 8:], [[8, 9, 10, 11]] * 3)
    with pytest.raises(ValueError, match="ordered"):
        tfm.mm_rope_positions(ids, [(6, vid), (3, img)])


@pytest.mark.parametrize("media", [
    [("image", (4, 4)), ("video", (2, 4, 4))],
    [("video", (7, 8, 8)), ("image", (6, 8)), ("video_tokens", 5)],
])
def test_build_mm_prompt_interleaved(media):
    tok, jtok = tqp.make_byte_qwen_tokenizer(), jqp.make_byte_qwen_tokenizer()
    ids, spans = tqp.build_mm_prompt(CFG, tok, "Compare them.", media)
    wids, wspans = jqp.build_mm_prompt(CFG, jtok, "Compare them.", media)
    np.testing.assert_array_equal(ids, wids)
    assert spans == wspans
    for (start, n, kind) in spans:
        pad = tok.special_id(tqp.IMAGE_PAD if kind == "image"
                             else tqp.VIDEO_PAD)
        assert (ids[start:start + n] == pad).all()
    with pytest.raises(ValueError, match="unknown media"):
        tqp.build_mm_prompt(CFG, tok, "Q", [("audio", 3)])


def test_build_video_prompt_grid_and_tokens():
    tok, jtok = tqp.make_byte_qwen_tokenizer(), jqp.make_byte_qwen_tokenizer()
    for kw in (dict(grid=(2, 4, 4)), dict(grid=(10, 4, 4)),
               dict(n_video_tokens=7)):
        ids, span = tqp.build_video_prompt(CFG, tok, "Q?", **kw)
        wids, wspan = jqp.build_video_prompt(CFG, jtok, "Q?", **kw)
        np.testing.assert_array_equal(ids, wids)
        assert span == wspan
    dam, csm = tvq.visual_token_count(CFG, 2, 4, 4)
    ids, (start, n) = tqp.build_video_prompt(CFG, tok, "Q?", grid=(2, 4, 4))
    assert n == dam + csm
    np.testing.assert_array_equal(
        tqp.visual_position_ids(ids, (start, n)),
        jqp.visual_position_ids(ids, (start, n)))


def test_qwen_prompt_token_count():
    """test_pipelines_e2e's case: (3, 4, 4) gives 8 DAM and 3 CSM tokens."""
    tok = tqp.make_byte_qwen_tokenizer()
    grid = (3, 4, 4)
    assert tvq.visual_token_count(CFG, *grid) == (8, 3)
    ids, span = tqp.build_video_prompt(CFG, tok, "Q?", grid=grid)
    start, n = span
    assert n == 11 and (ids[start:start + n] == CFG.video_token_id).all()
    vpi = tqp.visual_position_ids(ids, span)
    assert (vpi[start:start + n] == np.arange(n)).all()
    assert (vpi[:start] == -1).all()


# ---------------------------------------------------------------------------
# the varlen ViT and the image encode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vit_params(pipes):
    jp, tp = pipes
    return jp.params, tp.params


def test_vit_blocks_padded_segments(vit_params):
    """Two grids in one sequence, padded with -1: every row, padding rows
    included, matches JAX."""
    jparams, tparams = vit_params
    grids = [(1, 4, 6), (1, 2, 2)]
    pos, seg = tv.prepare_vit_inputs(grids, pad_to=40)
    wpos, wseg = jv.prepare_vit_inputs(grids, pad_to=40)
    np.testing.assert_array_equal(pos, wpos)
    np.testing.assert_array_equal(seg, wseg)
    assert (seg[28:] == -1).all() and set(seg[:28]) == {0, 1}
    pd = 3 * 2 * 14 * 14
    patches = np.random.default_rng(0).normal(size=(40, pd)).astype(
        np.float32)
    want = np.asarray(jv.qwen_vit_blocks(
        jparams["vit"], CFG.vit, jnp.asarray(patches), jnp.asarray(pos),
        jnp.asarray(seg)))
    got = tv.qwen_vit_blocks(tparams["vit"], CFG.vit,
                             torch.from_numpy(patches), pos, seg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    with pytest.raises(ValueError, match="exceed"):
        tv.prepare_vit_inputs(grids, pad_to=20)


@pytest.mark.parametrize("hw", [(8, 8), (6, 10)])
def test_encode_image(vit_params, hw):
    jparams, tparams = vit_params
    h, w = hw
    pd = 3 * 2 * 14 * 14
    patches = np.random.default_rng(1).normal(size=(h * w, pd)).astype(
        np.float32)
    want = jvq.encode_image(jparams, CFG, jnp.asarray(patches), hw)
    got = tvq.encode_image(tparams, CFG, torch.from_numpy(patches), hw)
    assert got.video_embeds.shape == (h * w // 4, CFG.llm.hidden_size)
    wv = np.asarray(want.video_embeds)
    np.testing.assert_allclose(got.video_embeds.numpy(), wv,
                               atol=1e-4 * np.abs(wv).max())
    np.testing.assert_array_equal(got.visual_positions.numpy(),
                                  np.asarray(want.visual_positions))
    assert (got.visual_positions[0] == 0).all()   # t axis: a still image


def test_encode_image_patch_norm(vit_params):
    """uint8 patches with `patch_norm` take JAX's f32 affine to bf16."""
    from flash_vstream_tpu.preprocess.image import qwen_patch_norm
    jparams, tparams = vit_params
    norm = qwen_patch_norm()
    u8 = np.random.default_rng(2).integers(0, 256, (16, 3 * 2 * 14 * 14),
                                           dtype=np.uint8)
    want = jvq.encode_image(jparams, CFG, jnp.asarray(u8), (4, 4),
                            patch_norm=norm)
    got = tvq.encode_image(tparams, CFG, torch.from_numpy(u8), (4, 4),
                           patch_norm=norm)
    np.testing.assert_allclose(got.video_embeds.float().numpy(),
                               np.asarray(want.video_embeds, np.float32),
                               atol=VIS_ATOL)


# ---------------------------------------------------------------------------
# QwenPipeline
# ---------------------------------------------------------------------------

def _jax_video_inputs(jp, frames, question, seed):
    """JAX's QwenPipeline.answer up to the generate call."""
    from flash_vstream_tpu.preprocess.image import (frame_hw, qwen_resize_u8,
                                                    smart_resize)
    H, W = frame_hw(frames[0])
    nh, nw = smart_resize(H, W, factor=56, max_pixels=jp.max_pixels)
    u8 = qwen_resize_u8(frames, (nh, nw))
    grid = (len(u8) // 2, nh // 14, nw // 14)
    vis = jp._encode_fn(grid)(jp.params, jnp.asarray(u8),
                              jax.random.PRNGKey(seed))
    ids, (start, n) = jqp.build_video_prompt(CFG, jp.tokenizer, question,
                                             grid=grid)
    embeds = jvq.splice_video_embeds(jp.params, CFG, ids, vis.video_embeds)
    pos, delta = jvq.build_qwen_positions(len(ids), start, n,
                                          vis.visual_positions)
    return (np.asarray(embeds), np.asarray(pos), len(ids) + int(delta),
            start, n)


def test_video_inputs_match_jax(pipes):
    """The default bf16 patch stream, 10 frame pairs in 4 scenes (t 10 > 4
    CSM clusters: k-means runs): the same positions and decode start, text
    embeddings equal, visual embeddings to bf16 rounding."""
    jp, tp = pipes
    frames = _scenes(0, (3, 2, 3, 2))
    want, wpos, wstart, start, n = _jax_video_inputs(jp, frames, Q, 3)
    embeds, pos, dstart = tp.video_inputs(frames, Q, draws=_draws(3))
    np.testing.assert_array_equal(pos.numpy(), wpos)
    assert dstart == wstart
    got = embeds.numpy()
    text = np.r_[0:start, start + n:got.shape[1]]
    np.testing.assert_array_equal(got[:, text], want[:, text])
    np.testing.assert_allclose(got[:, start:start + n],
                               want[:, start:start + n], atol=VIS_ATOL)


@pytest.mark.parametrize("seed,sizes", [(0, (3, 2, 3, 2)), (5, (2, 2, 1))])
def test_answer_same_ids_as_jax(f32_patches, seed, sizes):
    """Greedy answers: the port, given JAX's draws for PRNGKey(seed), gives
    JAX's token ids, and its text; with its own draws for the same seed it
    is deterministic."""
    jp, tp = f32_patches
    frames = _scenes(seed, sizes)
    gen_j = JGen(max_new_tokens=12)
    gen_t = GenerationConfig(max_new_tokens=12)
    jp.tokenizer.ids.clear()
    wtext = jp.answer(frames, Q, gen=gen_j, seed=seed)
    draws = _draws(seed)
    ids = tp.answer_tokens(frames, Q, gen_t, draws=draws)
    assert ids == jp.tokenizer.ids[-1] and len(ids) == 12
    assert tp.answer(frames, Q, gen_t, draws=draws) == wtext
    own = tp.answer_tokens(frames, Q, gen_t, seed=seed)
    assert own == tp.answer_tokens(frames, Q, gen_t, seed=seed)


def test_answer_image_same_ids_as_jax(f32_patches):
    """A 120 x 160 image (smart-resized to 112 x 168: an 8 x 12 grid):
    the same token ids and text, positions and decode start."""
    jp, tp = f32_patches
    image = np.random.default_rng(0).integers(0, 255, (120, 160, 3),
                                              dtype=np.uint8)
    gen_j, gen_t = JGen(max_new_tokens=10), GenerationConfig(max_new_tokens=10)
    jp.tokenizer.ids.clear()
    wtext = jp.answer_image(image, "What is shown?", gen=gen_j)
    ids = tp.answer_image_tokens(image, "What is shown?", gen_t)
    assert ids == jp.tokenizer.ids[-1]
    assert tp.answer_image(image, "What is shown?", gen_t) == wtext
    embeds, pos, start = tp.image_inputs(image, "What is shown?")
    ids_p, spans = tqp.build_mm_prompt(CFG, tp.tokenizer, "What is shown?",
                                       [("image", (8, 12))])
    s0, n, _ = spans[0]
    assert n == 24 and embeds.shape[1] == len(ids_p)
    want, wdelta = jfm.mm_rope_positions(ids_p, [(s0, jvq.mm_grid_index(
        1, 8, 12))])
    np.testing.assert_array_equal(pos[:, 0].numpy(), want)
    assert start == len(ids_p) + wdelta


def test_offline_qa_mechanics(pipes):
    """test_pipelines_e2e's Qwen cases on the port: synthetic frames give a
    string, the same one twice; 20 frames of 56 px (smart-resized to the
    112 px minimum: grid (10, 8, 8), t 10 over 4 CSM clusters and 2 DAM
    frames) stay within the memory's token budget."""
    _, tp = pipes
    gen = GenerationConfig(max_new_tokens=8)
    frames = list(SyntheticSource(6, 56, 56))
    out = tp.answer(frames, "What color is the object?", gen=gen)
    assert isinstance(out, str)
    assert out == tp.answer(frames, "What color is the object?", gen=gen)
    frames = list(SyntheticSource(20, 56, 56))
    embeds, _, _ = tp.video_inputs(frames, "Summarize.")
    assert tvq.visual_token_count(CFG, 10, 4, 4) == (8, 4)
    assert tvq.visual_token_count(CFG, 10, 8, 8) == (2 * 16, 4 * 4)
    ids, (_, n) = tqp.build_video_prompt(CFG, tp.tokenizer, "Summarize.",
                                         grid=(10, 8, 8))
    assert embeds.shape[1] == len(ids) and n == 48
