"""The port's LLaVA family (CLIP, projector, frame encode, the prompt
splice, `LLaVAPipeline` and `LLaVAStreamSession`) held against the JAX
package on the tiny LLaVA config, f32 weights on the CPU.

CLIP runs in f32 on both sides here (the device preprocess gives f32
images, the weights are f32), so features agree to f32 rounding: 1e-4 of
their scale. Token ids, positions, segment rows and validity are equal.
The answers must be JAX's token ids; the port takes JAX's draws (the
k-means init of PRNGKey(seed) offline, of PRNGKey(step) per ingest, the
Gumbel noise of sampled decodes). The frames are scenes with noise, so
k-means decides by wide margins; the one deviation accepted is an exact
retrieval tie (two equal-weight frames equally near their cluster's
centroid, either retrieved), and the session's answers are held on JAX's
snapshot of each ingest (a tie changes the key frames).

The machine with the card has no JAX, so JAX loads in fixtures; there the
card test runs alone:
    python -m pytest --noconftest -m gpu tests/test_torch_llava.py
"""
import numpy as np
import pytest
import torch

from flash_vstream_tpu_torch.core.config import tiny_llava_config
from flash_vstream_tpu_torch.models import clip_vit as tclip
from flash_vstream_tpu_torch.models import projector as tproj
from flash_vstream_tpu_torch.models import vstream_llava as tvl
from flash_vstream_tpu_torch.models.star_memory import STARMemory
from flash_vstream_tpu_torch.preprocess import image as timg
from flash_vstream_tpu_torch.preprocess.tokenizer import (ByteTokenizer,
                                                          tokenizer_image_token)
from flash_vstream_tpu_torch.runtime.generation import GenerationConfig
from flash_vstream_tpu_torch.runtime.pipeline import LLaVAPipeline
from flash_vstream_tpu_torch.runtime.streaming import LLaVAStreamSession

torch.set_num_threads(1)
CFG = tiny_llava_config()
Q = "What happens in the video?"
FEAT_ATOL = 1e-4


class J:
    """The JAX package's pieces and the shared parameters, on first use."""

    def __init__(self):
        jax = pytest.importorskip("jax")
        from flash_vstream_tpu.core.config import tiny_llava_config as jcfg
        from flash_vstream_tpu.models import vstream_llava
        from flash_vstream_tpu.preprocess.tokenizer import ByteTokenizer as jb
        from flash_vstream_tpu.runtime import generation, pipeline, streaming
        from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy
        self.jax, self.cfg, self.tok = jax, jcfg, jb
        self.gen, self.pipeline, self.streaming = generation, pipeline, streaming
        self.vl = vstream_llava
        self.params = vstream_llava.init_llava_params(jax.random.PRNGKey(0),
                                                      jcfg())
        self.tparams = params_from_numpy(jax.tree.map(np.asarray,
                                                      self.params), "cpu")

    def uniforms(self, step, n):
        return torch.from_numpy(np.array(self.jax.random.uniform(
            self.jax.random.PRNGKey(step), (n,))))

    def draws(self, seed):
        return lambda n: self.uniforms(seed, n)

    def gumbel(self, gen, shape, device):
        """JAX's sampling noise: PRNGKey(seed), then one split a token."""
        import jax.numpy as jnp
        key = sub = self.jax.random.PRNGKey(gen.seed)
        while True:
            yield torch.from_numpy(np.array(self.jax.random.gumbel(
                sub, shape, jnp.float32))).to(device)
            key, sub = self.jax.random.split(key)

    def record(self, generator):
        """Record the ids of a JAX Generator's `generate` calls."""
        ids, generate = [], generator.generate

        def recorded(*a, **k):
            out = generate(*a, **k)
            ids.append([int(t) for t in out])
            return out
        generator.generate = recorded
        return ids

    def pair(self, **kw):
        """A JAX session and the port's on the same tree and draws."""
        jsess = self.streaming.LLaVAStreamSession(self.params, self.cfg(),
                                                  self.tok(), **kw)
        tsess = LLaVAStreamSession(self.tparams, CFG, ByteTokenizer(), **kw)
        tsess._uniforms = self.uniforms
        tsess.generator.gumbel = self.gumbel
        return jsess, tsess


@pytest.fixture(scope="module")
def j():
    return J()


def _scenes(rng, n=3, side=112):
    return rng.integers(0, 256, size=(n, side, side, 3))


def _frames(rng, scenes, first, n, per_scene=3):
    """n frames from frame index `first` on: scene (i // per_scene) with
    noise, so clustering has structure."""
    return [np.clip(scenes[((first + i) // per_scene) % len(scenes)]
                    + rng.integers(-40, 41, scenes[0].shape), 0, 255)
            .astype(np.uint8) for i in range(n)]


def close(got, want, atol=FEAT_ATOL, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    np.testing.assert_allclose(got, np.asarray(want, np.float64), atol=atol,
                               rtol=0, err_msg=msg)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_patchify_images_matches_jax(j, rng):
    x = rng.normal(size=(2, 3, 28, 42)).astype(np.float32)
    from flash_vstream_tpu.models import clip_vit as jclip
    np.testing.assert_array_equal(
        tclip.patchify_images(torch.from_numpy(x), 14).numpy(),
        np.asarray(jclip.patchify_images(j.jax.numpy.asarray(x), 14)))


@pytest.mark.parametrize("select_layer", [-2, -1, 1])
def test_clip_encode_matches_jax(j, rng, select_layer):
    import dataclasses
    from flash_vstream_tpu.models import clip_vit as jclip
    vcfg = dataclasses.replace(CFG.vit, select_layer=select_layer)
    x = rng.normal(size=(3, 3, 112, 112)).astype(np.float32)
    got = tclip.clip_encode(j.tparams["vit"], vcfg, torch.from_numpy(x))
    want = jclip.clip_encode(j.params["vit"], vcfg, j.jax.numpy.asarray(x))
    assert got.shape == want.shape == (3, 64, 32)
    close(got, want)
    assert tclip.clip_layers_run(vcfg) == {-2: 1, -1: 2, 1: 1}[select_layer]


@pytest.mark.parametrize("ptype", ["identity", "linear", "mlp2x_gelu",
                                   "mlp3x_gelu"])
def test_project_matches_jax(j, rng, ptype):
    import dataclasses
    from flash_vstream_tpu.core.config import ProjectorConfig as JP
    from flash_vstream_tpu.models import projector as jproj
    from flash_vstream_tpu_torch.core.config import ProjectorConfig
    from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy
    pc = ProjectorConfig(projector_type=ptype, input_dim=32, output_dim=64)
    jp = jproj.init_projector_params(j.jax.random.PRNGKey(3), JP(
        **dataclasses.asdict(pc)))
    tp = params_from_numpy(j.jax.tree.map(np.asarray, jp), "cpu")
    x = rng.normal(size=(5, 32)).astype(np.float32)
    got = tproj.project(tp, pc, torch.from_numpy(x))
    want = jproj.project(jp, JP(**dataclasses.asdict(pc)),
                         j.jax.numpy.asarray(x))
    close(got, want, 1e-5)
    init = tproj.init_projector_params(pc, torch.Generator().manual_seed(0),
                                       "cpu")
    assert j.jax.tree.map(np.shape, jp) == {
        k: [{n: tuple(v.shape) for n, v in lp.items()} for lp in ls]
        for k, ls in init.items()}
    with pytest.raises(ValueError, match="unknown projector"):
        tproj.project(tp, ProjectorConfig(projector_type="conv"),
                      torch.from_numpy(x))


def test_init_llava_params_tree_matches_jax(j):
    p = tvl.init_llava_params(CFG, torch.Generator().manual_seed(0), "cpu")
    want = j.jax.tree.map(np.shape, j.params)

    def shapes(v):
        if isinstance(v, dict):
            return {k: shapes(x) for k, x in v.items()}
        if isinstance(v, list):
            return [shapes(x) for x in v]
        if hasattr(v, "_fields"):
            return type(want["ntm"])(*(tuple(f.shape) for f in v))
        return tuple(v.shape)
    assert shapes(p) == want


@pytest.mark.parametrize("merge4", [False, True])
def test_encode_frames_matches_jax(j, rng, merge4):
    import dataclasses
    cfg = CFG.replace(projector=dataclasses.replace(
        CFG.projector, use_4_vision_tokens=merge4))
    jc = j.cfg().replace(projector=dataclasses.replace(
        j.cfg().projector, use_4_vision_tokens=merge4))
    if merge4:      # a 2x2 merge leaves a 4 x 4 grid: pool to it
        cfg = cfg.replace(star=dataclasses.replace(cfg.star, current_size=4))
        jc = jc.replace(star=dataclasses.replace(jc.star, current_size=4))
    u8 = rng.integers(0, 256, (2, 112, 112, 3), dtype=np.uint8)
    got = tvl.encode_frames(j.tparams, cfg, timg.clip_device_preprocess(
        torch.from_numpy(u8)))
    from flash_vstream_tpu.preprocess.image import clip_device_preprocess
    want = j.vl.encode_frames(j.params, jc, clip_device_preprocess(
        j.jax.numpy.asarray(u8)))
    assert got.shape == want.shape
    close(got, want)


def test_clip_preprocessors_match_jax(j, rng):
    from flash_vstream_tpu.preprocess import image as jimg
    frames = [rng.integers(0, 256, (60, 90, 3), dtype=np.uint8),
              rng.integers(0, 256, (112, 112, 3), dtype=np.uint8),
              rng.random((3, 40, 30)).astype(np.float32)]
    for size in (112, 224):
        np.testing.assert_array_equal(timg.clip_resize_u8(frames, size),
                                      jimg.clip_resize_u8(frames, size))
        np.testing.assert_array_equal(timg.clip_preprocess(frames, size),
                                      jimg.clip_preprocess(frames, size))
    img = rng.random((3, 20, 32)).astype(np.float32)
    np.testing.assert_array_equal(timg.expand2square(img, (0.1, 0.2, 0.3)),
                                  jimg.expand2square(img, (0.1, 0.2, 0.3)))
    u8 = rng.integers(0, 256, (2, 28, 28, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        timg.clip_device_preprocess(torch.from_numpy(u8)).numpy(),
        np.asarray(jimg.clip_device_preprocess(j.jax.numpy.asarray(u8))))


@pytest.mark.parametrize("hw,out", [((60, 90), (112, 112)),
                                    ((448, 448), (224, 224)),
                                    ((336, 448), (224, 224)),
                                    ((112, 112), (224, 224)),
                                    ((7, 300), (50, 33)),
                                    ((480, 640), (224, 336))])
def test_numpy_resize_equals_pil_bit_for_bit(hw, out):
    """`resize_u8` (numpy: the port needs no PIL) is PIL's bicubic resize
    bit for bit, down and up, one axis or both; so is the CLIP host
    preprocess built on it, against the JAX package's (through PIL)."""
    from PIL import Image
    from flash_vstream_tpu.preprocess import image as jimg
    rng = np.random.default_rng(hw[0] * 7 + out[1])
    img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(out[::-1], Image.BICUBIC))
    np.testing.assert_array_equal(timg.resize_u8(img, out), want)
    np.testing.assert_array_equal(timg.clip_resize_u8([img], 112),
                                  jimg.clip_resize_u8([img], 112))


@pytest.mark.parametrize("prompt", [
    "A chat. USER: <image>\nWhat? ASSISTANT:", "<image>", "no image here",
    "two <image> and <image> end", "<image>\n<image>"])
def test_tokenizer_image_token_matches_jax(j, prompt):
    from flash_vstream_tpu.preprocess.tokenizer import (
        tokenizer_image_token as jtit)
    got = tokenizer_image_token(prompt, ByteTokenizer())
    want = jtit(prompt, j.tok())
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64
    assert (got == -200).sum() == prompt.count("<image>")


@pytest.mark.parametrize("streaming", [False, True])
def test_star_valid_counts_match_jax(j, streaming):
    from flash_vstream_tpu_torch.core.config import VStreamLLaVAConfig
    from flash_vstream_tpu.core.config import VStreamLLaVAConfig as JV
    for cfg, jc in ((CFG, j.cfg()), (VStreamLLaVAConfig(), JV())):
        for n in range(0, 70):
            assert tvl.star_valid_counts(cfg, n, streaming) == \
                j.vl.star_valid_counts(jc, n, streaming)
    # saturated at full width: 25 + 400 + 3 x 64 + 64 = 681 tokens
    assert sum(tvl.star_valid_counts(VStreamLLaVAConfig(), 64, True)) == 681


def test_pack_and_splice_match_jax(j, rng):
    """`build_multimodal_embeds` over one consolidated memory: the packed
    tokens, the projected splice and the positions."""
    from flash_vstream_tpu.models.star_memory import STARMemory as JM
    T = 6
    feats = rng.normal(size=(8, 64, 32)).astype(np.float32)
    key = j.jax.random.PRNGKey(0)
    jmem = j.vl.consolidate(j.params, j.cfg(), j.jax.numpy.asarray(feats),
                            j.jax.numpy.int32(T), key)
    tmem = tvl.consolidate(j.tparams, CFG, torch.from_numpy(feats), T,
                           j.draws(0))
    mem = STARMemory(torch.from_numpy(np.array(jmem.tokens)),
                     torch.from_numpy(np.array(jmem.valid)))
    np.testing.assert_array_equal(tmem.valid.numpy(), mem.valid.numpy())
    n = sum(tvl.star_valid_counts(CFG, T))
    close(tvl.pack_memory_tokens(mem, n + 5),
          j.vl.pack_memory_tokens(JM(jmem.tokens, jmem.valid), n + 5), 0)
    ids = tokenizer_image_token("USER: <image>\nWhat? ASSISTANT:",
                                ByteTokenizer())
    e, p = tvl.build_multimodal_embeds(j.tparams, CFG, ids, mem, T)
    je, jpos = j.vl.build_multimodal_embeds(j.params, j.cfg(), ids, jmem, T)
    close(e, je, 1e-5)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jpos))
    with pytest.raises(ValueError, match="one <image>"):
        tvl.build_multimodal_embeds(j.tparams, CFG, ids[:3], mem, T)


# ---------------------------------------------------------------------------
# offline QA
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipes(j):
    jtok = j.tok()
    jpipe = j.pipeline.LLaVAPipeline(j.params, j.cfg(), jtok, max_len=1024)
    tpipe = LLaVAPipeline(j.tparams, CFG, ByteTokenizer(), max_len=1024)
    tpipe.generator.gumbel = j.gumbel
    return jpipe, tpipe


@pytest.mark.parametrize("n,seed", [(1, 0), (4, 1), (9, 0), (20, 2)])
def test_pipeline_answer_same_ids_as_jax(j, pipes, n, seed):
    """The answer over n frames (history shorter and longer than the long
    memory, a bucket of 32) is JAX's ids; features within 1e-4."""
    jpipe, tpipe = pipes
    rng = np.random.default_rng(n)
    frames = _frames(rng, _scenes(rng), 0, n)
    close(tpipe.encode_video(frames), jpipe.encode_video(frames))
    ids = j.record(jpipe.generator)
    try:
        kw = dict(max_new_tokens=8, eos_token_ids=())
        jtext = jpipe.answer(frames, Q, j.gen.GenerationConfig(**kw),
                             seed=seed)
    finally:
        del jpipe.generator.generate
    got = tpipe.answer_tokens(frames, Q, GenerationConfig(**kw),
                              draws=j.draws(seed))
    assert got == ids[-1] and len(got) == 8
    assert tpipe.answer(frames, Q, GenerationConfig(**kw),
                        draws=j.draws(seed)) == jtext


def test_pipeline_sampled_answer_same_ids_as_jax(j, pipes):
    jpipe, tpipe = pipes
    rng = np.random.default_rng(5)
    frames = _frames(rng, _scenes(rng), 0, 7)
    kw = dict(max_new_tokens=8, eos_token_ids=(), temperature=0.7, top_k=40,
              top_p=0.9, seed=4)
    ids = j.record(jpipe.generator)
    try:
        jpipe.answer(frames, Q, j.gen.GenerationConfig(**kw), seed=3)
    finally:
        del jpipe.generator.generate
    assert tpipe.answer_tokens(frames, Q, GenerationConfig(**kw),
                               draws=j.draws(3)) == ids[-1]


@pytest.mark.parametrize("hw", [(112, 112), (90, 140), (200, 120)])
def test_pipeline_answer_image_same_ids_as_jax(j, pipes, hw):
    """One image: its full CLIP patch grid (64 tokens at the tiny config's
    112 px) projected, no memory."""
    jpipe, tpipe = pipes
    rng = np.random.default_rng(hw[0])
    image = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    kw = dict(max_new_tokens=8, eos_token_ids=())
    ids = j.record(jpipe.generator)
    try:
        jtext = jpipe.answer_image(image, Q, j.gen.GenerationConfig(**kw))
    finally:
        del jpipe.generator.generate
    assert tpipe.answer_image_tokens(image, Q, GenerationConfig(**kw)) \
        == ids[-1]
    assert tpipe.answer_image(image, Q, GenerationConfig(**kw)) == jtext


def test_pipeline_default_draws_and_features(pipes):
    """Without draws the port seeds its own generator (the same seed twice
    gives the same answer); precomputed features answer as frames do."""
    _, tpipe = pipes
    rng = np.random.default_rng(9)
    frames = _frames(rng, _scenes(rng), 0, 12)
    gen = GenerationConfig(max_new_tokens=6, eos_token_ids=())
    a = tpipe.answer_tokens(frames, Q, gen, seed=1)
    assert a == tpipe.answer_tokens(frames, Q, gen, seed=1)
    assert a == tpipe.answer_tokens(None, Q, gen, seed=1,
                                    features=tpipe.encode_video(frames))


# ---------------------------------------------------------------------------
# the streaming session
# ---------------------------------------------------------------------------

def _jax_snapshot(jmem):
    return STARMemory(torch.from_numpy(np.array(jmem.tokens)),
                      torch.from_numpy(np.array(jmem.valid)))


def _key_tie(cfg, state, slot, got_rows, want_rows):
    """Whether key slot `slot`'s query cluster of the port's `state` is as
    near to the frame the port took as to JAX's (relative 1e-4)."""
    from flash_vstream_tpu_torch.ops.pooling import spatial_pool
    from flash_vstream_tpu_torch.ops.retrieval import topk_by_weight
    L = cfg.star.long_length
    q = state.long.reshape(L, -1)[topk_by_weight(state.long_weights,
                                                 cfg.star.key_length)[slot]]

    def dist(rows):
        f = spatial_pool(rows, cfg.star.long_size).reshape(-1)
        return float(((f - q) ** 2).sum())
    dg, dw = dist(got_rows), dist(want_rows)
    return abs(dg - dw) <= 1e-4 * max(dg, dw)


def _check_snapshot(cfg, state, got, want, msg):
    """Validity equal, tokens within FEAT_ATOL, key slots equal or an
    exact tie. Returns the tied slots."""
    np.testing.assert_array_equal(got.valid.numpy(), want.valid.numpy(),
                                  err_msg=msg)
    s = cfg.star
    n0 = s.turing_length * s.turing_size ** 2 + s.long_length * s.long_size ** 2
    Pc = s.current_size ** 2
    ties = 0
    for k in range(s.key_length):
        a = slice(n0 + k * Pc, n0 + (k + 1) * Pc)
        d = (got.tokens[a] - want.tokens[a]).abs().max()
        if d > FEAT_ATOL and got.valid[a].any():
            assert _key_tie(cfg, state, k, got.tokens[a], want.tokens[a]), \
                (msg, k)
            ties += 1
            want.tokens[a] = got.tokens[a]
    close(got.tokens, want.tokens, FEAT_ATOL, msg)
    return ties


def _run_pair(j, clips, clip_size, seed, qgen=None):
    """Stream `clips` (frames per ingest) through a pair; after every
    ingest: both snapshots, JAX's fused greedy ids, the port's ids on
    JAX's snapshot."""
    jsess, tsess = j.pair(clip_size=clip_size, max_len=1024)
    rng = np.random.default_rng(seed)
    scenes = _scenes(rng, 4)
    jgen = j.gen.GenerationConfig(max_new_tokens=6, eos_token_ids=())
    gen = GenerationConfig(max_new_tokens=6, eos_token_ids=())
    steps, first = [], 0
    for n in clips:
        frames = _frames(rng, scenes, first, n)
        first += n
        jsess.ingest_frames(frames)
        tsess.ingest_frames(frames)
        jmem, jn = jsess._published
        tmem, tn = tsess._published
        snap = _jax_snapshot(jmem)
        steps.append(dict(
            n=tn, jn=jn, snap=snap, got=tmem,
            state=tsess.state._replace(**{
                f: getattr(tsess.state, f).clone()
                for f in ("long", "long_weights")}),
            jids=[int(t) for t in jsess._answer_fused(Q, jmem, jn, jgen)],
            tids=tsess.answer_tokens(snap, tn, Q, gen)))
    return jsess, tsess, steps


@pytest.fixture(scope="module")
def stream1(j):
    """clip_size 1: 20 frames, the 16-frame bank wraps."""
    return _run_pair(j, [1] * 20, 1, 0)


@pytest.fixture(scope="module")
def stream4(j):
    """clip_size 4 with partial clips: 25 frames, the bank wraps."""
    return _run_pair(j, [1, 4, 3, 4, 2, 4, 4, 3], 4, 1)


@pytest.mark.parametrize("which", ["stream1", "stream4"])
def test_session_snapshot_and_ids_at_every_ingest(request, which):
    """Every ingest's snapshot agrees with JAX's (an exact key-frame tie
    aside) and the greedy answer on it is JAX's ids: before the long
    memory saturates, at saturation, and after the bank wraps."""
    _, tsess, steps = request.getfixturevalue(which)
    cfg = tsess.cfg
    for i, s in enumerate(steps):
        assert s["n"] == s["jn"]
        _check_snapshot(cfg, s["state"], s["got"], s["snap"].__class__(
            s["snap"].tokens.clone(), s["snap"].valid), f"ingest {i}")
        assert s["tids"] == s["jids"] and len(s["tids"]) == 6, f"ingest {i}"
    ns = [s["n"] for s in steps]
    assert ns[0] <= cfg.star.long_length < ns[-1]
    assert ns[-1] > cfg.star.max_frames_static            # wrapped
    # early answers run on padded memory slots (segment -1), later ones on
    # the saturated memory
    real = [sum(tvl.star_valid_counts(cfg, n, streaming=True)) for n in ns]
    padded = [r < tsess._bucket_n_mem(r) for r in real]
    assert padded[0] and not padded[-1]


def test_session_buckets_match_jax(j, stream4):
    jsess, tsess, _ = stream4
    for n in range(1, 40):
        real = sum(tvl.star_valid_counts(CFG, n, streaming=True))
        assert tsess._bucket_n_mem(real) == jsess._bucket_n_mem(real)


def test_session_prompt_parts_match_jax(stream4):
    """Embeddings, positions, segment row, decode start and last index of
    the prompt equal JAX's on the same snapshot (padded memory slots at
    segment -1, the question's positions after the real memory)."""
    jsess, tsess, steps = stream4
    jm, jn = jsess._published
    want = jsess._prompt_parts(Q, jm, jn)
    got = tsess._prompt_parts(Q, _jax_snapshot(jm), jn)
    close(got[0], want[0], 1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] == want[2] and got[4] == want[4]
    np.testing.assert_array_equal(got[3], want[3])
    early = tsess._prompt_parts(Q, steps[0]["snap"], steps[0]["n"])
    assert (early[3] == -1).any()          # padded slots in a small bucket


@pytest.mark.parametrize("kw", [
    dict(temperature=0.8, top_k=50, top_p=0.9, seed=3),
    dict(preemptible_chunk=3),
    dict(preemptible_chunk=3, prefill_chunk=40),
    dict(speculative_k=3, speculative_ngram=2),
], ids=["sampled", "preemptible", "prefill_chunks", "speculative"])
def test_session_decode_kinds_match_jax(j, stream4, kw):
    """Each decode kind gives JAX's ids on JAX's snapshot (sampled: from
    JAX's draws); the preemptible, chunked and speculative ones are also
    the greedy ids."""
    jsess, tsess, _ = stream4
    jm, jn = jsess._published
    snap = _jax_snapshot(jm)
    base = dict(max_new_tokens=10, eos_token_ids=())
    ids = j.record(jsess.generator)
    try:
        jtext = jsess.answer(Q, j.gen.GenerationConfig(**base, **kw))
    finally:
        del jsess.generator.generate
    got = tsess.answer_tokens(snap, jn, Q, GenerationConfig(**base, **kw))
    assert got == ids[-1] and len(got) == 10
    text = ByteTokenizer().decode(got)
    from flash_vstream_tpu_torch.runtime.generation import trim_stop_strings
    assert trim_stop_strings(text, ("</s>",)) == jtext
    if "temperature" not in kw:
        assert got == tsess.answer_tokens(snap, jn, Q,
                                          GenerationConfig(**base))


def test_session_answer_stream_matches_jax(j, stream1):
    """The text deltas of `answer_stream` are JAX's, one for one, and join
    to the answer."""
    jsess, tsess, _ = stream1
    tsess._published = (_jax_snapshot(jsess._published[0]),
                        jsess._published[1])
    kw = dict(max_new_tokens=12, eos_token_ids=(257,))
    want = list(jsess.answer_stream(Q, j.gen.GenerationConfig(**kw)))
    got = list(tsess.answer_stream(Q, GenerationConfig(**kw)))
    assert got == want
    assert "".join(got) == tsess.answer(Q, GenerationConfig(**kw))


@pytest.mark.parametrize("kw", [
    dict(), dict(preemptible_chunk=3, prefill_chunk=40),
    dict(speculative_k=3, speculative_ngram=2),
], ids=["greedy", "prefill_chunks", "speculative"])
def test_session_int8_kv_matches_jax(j, stream4, kw):
    """With an int8 KV cache (jnp.int8 / torch.int8) the answer on JAX's
    snapshot is JAX's ids, and the chunked and speculative ones are the
    greedy ids."""
    import jax.numpy as jnp
    jsess0, tsess0, _ = stream4
    jm, jn = jsess0._published
    jsess = j.streaming.LLaVAStreamSession(j.params, j.cfg(), j.tok(),
                                           clip_size=4, max_len=1024,
                                           kv_cache_dtype=jnp.int8)
    tsess = LLaVAStreamSession(j.tparams, CFG, ByteTokenizer(), clip_size=4,
                               max_len=1024, kv_cache_dtype=torch.int8)
    base = dict(max_new_tokens=8, eos_token_ids=())
    snap = _jax_snapshot(jm)
    greedy = tsess.answer_tokens(snap, jn, Q, GenerationConfig(**base))
    if kw:
        jsess._published = (jm, jn)
        ids = j.record(jsess.generator)
        try:
            jsess.answer(Q, j.gen.GenerationConfig(**base, **kw))
        finally:
            del jsess.generator.generate
        want = ids[-1]
    else:
        want = [int(t) for t in jsess._answer_fused(
            Q, jm, jn, j.gen.GenerationConfig(**base))]
    got = tsess.answer_tokens(snap, jn, Q, GenerationConfig(**base, **kw))
    assert got == want == greedy and len(got) == 8
    assert tsess.generator.new_cache(1, 8).k.dtype == torch.int8
    assert tsess.clone_fresh().generator.cache_dtype == torch.int8


def test_session_clone_fresh_is_independent(stream1):
    _, tsess, _ = stream1
    before = {k: v.clone() for k, v in tsess.state._asdict().items()
              if isinstance(v, torch.Tensor)}
    published, step = tsess._published, tsess._step
    c = tsess.clone_fresh()
    assert c.params is tsess.params and c.generator is tsess.generator
    assert c.metrics is not tsess.metrics
    assert c._published == (None, 0) and c._step == 0 and c.n_frames == 0
    for k, v in c.state._asdict().items():
        if isinstance(v, torch.Tensor):
            assert v.data_ptr() != getattr(tsess.state, k).data_ptr(), k
    rng = np.random.default_rng(7)
    for _ in range(3):
        c.ingest_frames(_frames(rng, _scenes(rng), 0, 1))
    assert c.n_frames == 3 and tsess._published is published
    assert tsess._step == step
    for k, v in before.items():
        assert torch.equal(getattr(tsess.state, k), v), k
    assert isinstance(c.answer(Q, GenerationConfig(max_new_tokens=2)), str)
    with pytest.raises(ValueError, match="exceed clip_size"):
        c.ingest_frames(_frames(rng, _scenes(rng), 0, 2))
    with pytest.raises(RuntimeError, match="no frames"):
        tsess.clone_fresh().answer(Q)


def test_session_save_resume_round_trip(stream4, tmp_path):
    _, tsess, _ = stream4
    path = tsess.save_session(str(tmp_path / "s.pt"))
    fresh = tsess.clone_fresh()
    fresh.load_session(path)
    assert fresh.n_frames == tsess.n_frames and fresh._step == tsess._step
    for a, b in zip(fresh.state, tsess.state):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
    for a, b in zip(fresh._published[0], tsess._published[0]):
        assert torch.equal(a, b)
    gen = GenerationConfig(max_new_tokens=6, eos_token_ids=())
    assert fresh.answer_tokens(*fresh._published, Q, gen) == \
        tsess.answer_tokens(*tsess._published, Q, gen)
    # the resumed stream goes on where the saved one stopped
    frames = [np.full((112, 112, 3), 90, np.uint8)] * 4
    other = tsess.clone_fresh()
    other.load_session(path)
    fresh.ingest_frames(frames)
    other.ingest_frames(frames)
    assert fresh.n_frames == tsess.n_frames + 4
    for a, b in zip(fresh._published[0], other._published[0]):
        assert torch.equal(a, b)
    empty = tsess.clone_fresh()
    empty.load_session(empty.save_session(str(tmp_path / "e.pt")))
    assert empty._published == (None, 0)
    import dataclasses
    small = LLaVAStreamSession(tsess.params, CFG.replace(
        star=dataclasses.replace(CFG.star, max_frames_static=8)),
        tsess.tokenizer, clip_size=4)
    with pytest.raises(ValueError, match="'bank'"):
        small.load_session(path)


def test_session_metrics(stream1):
    _, tsess, _ = stream1
    m = tsess.metrics.as_dict()
    assert m["memory_latency_dispatch"]["count"] == 20
    assert m["memory_latency_host_preprocess"]["count"] == 20


@pytest.mark.gpu
def test_session_on_card_matches_cpu():
    """The tiny LLaVA session on the card (bf16 weights; K1 zero-pads the
    head dims 8 and 16 to 64) answers the ids its CPU twin answers on the
    same bf16 weights, on the card's snapshot, greedy and preemptible with
    prefill chunks; the card's snapshot is within bf16 rounding of the
    CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (sm_90a)")
    from flash_vstream_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda)
    dev = torch.device("cuda")
    params = tvl.init_llava_params(CFG, torch.Generator().manual_seed(0),
                                   "cpu", dtype=torch.bfloat16)

    def to(tree, d):
        if isinstance(tree, dict):
            return {k: to(v, d) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, d) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*(f.to(d) for f in tree))
        return tree.to(d)
    card = LLaVAStreamSession(to(params, dev), CFG, ByteTokenizer(),
                              clip_size=2, max_len=1024)
    cpu = LLaVAStreamSession(params, CFG, ByteTokenizer(), clip_size=2,
                             max_len=1024)
    cpu._uniforms = lambda step, n: card._uniforms(step, n).cpu()
    rng = np.random.default_rng(0)
    scenes = _scenes(rng)
    n0 = flash_attention_cuda.launches
    for i in range(10):
        frames = _frames(rng, scenes, 2 * i, 2)
        card.ingest_frames(frames)
        cpu.ingest_frames(frames)
    assert flash_attention_cuda.launches > n0
    snap = STARMemory(*(x.cpu() for x in card._published[0]))
    csnap = cpu._published[0]
    np.testing.assert_array_equal(snap.valid.numpy(), csnap.valid.numpy())
    scale = csnap.tokens.abs().max().item()
    assert (snap.tokens - csnap.tokens).abs().max().item() <= 5e-2 * scale
    base = dict(max_new_tokens=12, eos_token_ids=())
    want = cpu.answer_tokens(snap, 20, Q, GenerationConfig(**base))
    dsnap = STARMemory(*(x.to(dev) for x in snap))
    for kw in (dict(), dict(preemptible_chunk=4, prefill_chunk=64),
               dict(speculative_k=3, speculative_ngram=2)):
        assert card.answer_tokens(dsnap, 20, Q,
                                  GenerationConfig(**base, **kw)) == want, kw
