"""The PyTorch port's streaming slice as a whole, held against the JAX
session: one parameter tree, the same frames, the same k-means init draws.

Both sessions run their default bf16 path (bf16 patch stream and ViT, bf16
frame banks), so the published snapshots agree to bf16 rounding, not to f32
precision: the two frameworks round bf16 matmuls on the CPU in different
places. The integer parts (frame positions, cluster timestamps) must be
equal, except at an exact DAM tie (two bank frames at the same distance
from a cluster, where either may be retrieved), and the answers must be the
same token ids: greedy, streamed, sampled from JAX's draws, preemptible and
speculative. Two sessions run: clip_size 2 answered after the memory
saturates, and clip_size 4 with partial clips answered after every ingest,
before saturation too (padded memory buckets). The session's clones and its
save/resume round trip are checked on the port alone.

The machine with the card has no JAX, so JAX loads in fixtures; there the
card test runs alone:
    python -m pytest --noconftest -m gpu tests/test_torch_streaming.py
"""
import numpy as np
import pytest
import torch

from flash_vstream_tpu_torch.core.config import tiny_qwen_config
from flash_vstream_tpu_torch.models.vstream_qwen import VStreamQwen
from flash_vstream_tpu_torch.ops.retrieval import topk_by_weight
from flash_vstream_tpu_torch.preprocess.qwen_processor import (
    make_byte_qwen_tokenizer)
from flash_vstream_tpu_torch.runtime.generation import GenerationConfig
from flash_vstream_tpu_torch.runtime.streaming import QwenStreamSession, bucket_up

torch.set_num_threads(1)

# features reach |x| ~ 5, where one bf16 ulp is 0.031; the sessions differ
# by at most 0.039 (one ulp plus the f32 noise under it)
FEATURE_ATOL = 5e-2
N_INGESTS = 7
KW = dict(frame_hw=(112, 112), clip_size=2, bank_size=16, max_len=512)
# clip_size 4, a bank of 6 frame pairs that wraps, and partial clips
KW4 = dict(frame_hw=(112, 112), clip_size=4, bank_size=6, max_len=512)
CLIPS4 = (1, 4, 3, 4, 2, 4)           # frames per ingest
Q = "What happens in the video?"


class J:
    """The JAX package's pieces, imported on first use."""

    def __init__(self):
        jax = pytest.importorskip("jax")
        from flash_vstream_tpu.core.config import tiny_qwen_config as jcfg
        from flash_vstream_tpu.models.vstream_qwen import init_qwen_params
        from flash_vstream_tpu.preprocess.qwen_processor import (
            make_byte_qwen_tokenizer as jtok)
        from flash_vstream_tpu.runtime import generation
        from flash_vstream_tpu.runtime import streaming
        from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy
        self.jax, self.cfg, self.tok = jax, jcfg, jtok
        self.gen, self.streaming = generation, streaming
        self.params = init_qwen_params(jax.random.PRNGKey(0), jcfg())
        self.model = VStreamQwen(tiny_qwen_config(), params_from_numpy(
            jax.tree.map(np.asarray, self.params), "cpu"))

    def scores(self, step, n):
        """The JAX session's k-means init draws."""
        return torch.from_numpy(np.array(self.jax.random.uniform(
            self.jax.random.PRNGKey(step), (n,))))

    def gumbel(self, gen, shape, device):
        """JAX's sampling noise: PRNGKey(seed), then one split a token."""
        import jax.numpy as jnp
        key = sub = self.jax.random.PRNGKey(gen.seed)
        while True:
            yield torch.from_numpy(np.array(self.jax.random.gumbel(
                sub, shape, jnp.float32))).to(device)
            key, sub = self.jax.random.split(key)

    def pair(self, **kw):
        """A JAX session and the port's on the same tree and draws."""
        jsess = self.streaming.QwenStreamSession(
            self.params, self.cfg(), self.tok(), **kw)
        tsess = QwenStreamSession(self.model, make_byte_qwen_tokenizer(),
                                  **kw)
        tsess._init_scores = self.scores
        tsess.generator.gumbel = self.gumbel
        return jsess, tsess

    def record(self, jsess):
        """Record the ids of the JAX session's non-fused answers."""
        ids, generate = [], jsess.generator.generate

        def recorded(*a, **k):
            out = generate(*a, **k)
            ids.append([int(t) for t in out])
            return out
        jsess.generator.generate = recorded
        return ids


@pytest.fixture(scope="module")
def j():
    return J()


def _frames(rng, scenes, i, n):
    """n frames of scene i // 2 with noise: clustering has structure."""
    return [np.clip(scenes[(i // 2) % len(scenes)]
                    + rng.integers(-64, 65, scenes[0].shape), 0, 255)
            .astype(np.uint8) for _ in range(n)]


def _snap_np(snap):
    return [x.float().numpy() if x.is_floating_point() else x.numpy()
            for x in snap]


def _snap_torch(jsnap, like):
    """The JAX session's snapshot as the port's tensors (dtypes of `like`)."""
    return tuple(torch.from_numpy(np.asarray(x, np.float32)
                                  if np.asarray(x).dtype.kind == "V"
                                  or str(np.asarray(x).dtype) == "bfloat16"
                                  else np.array(x)).to(y.dtype)
                 for x, y in zip(jsnap, like))


def _dam_tie(state, t_dam, j, p_a, p_b):
    """Whether DAM slot j's query cluster is as near to bank frame p_a as
    to p_b (an exact k-means tie, up to bf16 rounding)."""
    w = torch.where(state.tem_valid, state.tem_weights, float("-inf"))
    q = state.tem_x[topk_by_weight(w, t_dam)[j]].float().flatten()

    def dist(p):
        slot = int((state.bank_pos == p).nonzero()[0, 0])
        return ((state.bank_small[slot].float().flatten() - q) ** 2).sum().item()

    return abs(dist(p_a) - dist(p_b)) <= 1e-2 * max(dist(p_a), dist(p_b))


def _check_snapshot(want, got, msg, state=None):
    """Positions equal (DAM slots may differ at an exact tie in the port's
    `state` of that ingest: returns how many did) and features within
    FEATURE_ATOL where the frames agree."""
    spa_pos, tem_pos, spa_x, tem_x = want
    np.testing.assert_array_equal(got[1], tem_pos, err_msg=msg)
    np.testing.assert_allclose(got[3], tem_x, atol=FEATURE_ATOL, err_msg=msg)
    ties = 0
    for j, (a, b) in enumerate(zip(got[0], spa_pos)):
        if a == b:
            np.testing.assert_allclose(
                got[2][j], np.asarray(spa_x[j], np.float32),
                atol=FEATURE_ATOL, err_msg=msg)
        else:
            assert state is not None and _dam_tie(
                state, len(spa_pos), j, int(a), int(b)), (msg, j, a, b)
            ties += 1
    return ties


@pytest.fixture(scope="module")
def sessions(j):
    jsess, tsess = j.pair(**KW)
    rng = np.random.default_rng(0)
    scenes = rng.integers(0, 256, size=(3, 112, 112, 3))
    snaps = []
    for i in range(N_INGESTS):
        frames = _frames(rng, scenes, i, 2)
        jsess.ingest_frames(frames)
        tsess.ingest_frames(frames)
        snaps.append((j.jax.tree.map(np.asarray, jsess._published[0]),
                      _snap_np(tsess._published[0])))
    return jsess, tsess, snaps


def test_snapshot_after_every_ingest(sessions):
    jsess, tsess, snaps = sessions
    for i, (want, got) in enumerate(snaps):
        np.testing.assert_array_equal(got[0], want[0], err_msg=f"ingest {i}")
        _check_snapshot(want, got, f"ingest {i}")
    assert tsess.n_frames == jsess.n_frames == N_INGESTS


def test_memory_saturates(sessions):
    _, tsess, _ = sessions
    fm = tsess.cfg.flash_memory
    # more frame pairs than clusters: CSM clustering and DAM retrieval ran
    assert tsess.n_frames > fm.csm_grid_len > fm.dam_grid_len
    assert bool(tsess.state.tem_valid.all())


def test_greedy_answer_token_ids(sessions, j):
    jsess, tsess, _ = sessions
    jgen = j.gen.GenerationConfig(max_new_tokens=8, eos_token_ids=())
    gen = GenerationConfig(max_new_tokens=8, eos_token_ids=())
    snap, n = jsess._published
    want = jsess._answer_fused(snap, n, Q, jgen)
    tsnap, tn = tsess._published
    got = tsess.answer_tokens(tsnap, tn, Q, gen)
    assert len(got) == 8
    assert got == want
    assert isinstance(tsess.answer(Q, gen), str)


def test_answer_stream_deltas(sessions, j):
    """The text deltas of `answer_stream` are JAX's, one for one."""
    jsess, tsess, _ = sessions
    kw = dict(max_new_tokens=12, eos_token_ids=(257,))
    want = list(jsess.answer_stream(Q, j.gen.GenerationConfig(**kw)))
    got = list(tsess.answer_stream(Q, GenerationConfig(**kw)))
    assert got == want
    assert "".join(got) == tsess.answer(Q, GenerationConfig(**kw))


@pytest.mark.parametrize("kw", [
    dict(temperature=0.8, top_k=50, top_p=0.9, seed=3),
    dict(preemptible_chunk=3),
    dict(preemptible_chunk=3, prefill_chunk=40),
    dict(speculative_k=3, speculative_ngram=2),
], ids=["sampled", "preemptible", "prefill_chunks", "speculative"])
def test_answer_variants_match_jax(sessions, j, kw):
    """Each answer is JAX's ids (sampled: from JAX's draws); the
    preemptible and speculative ones are also the greedy ids."""
    jsess, tsess, _ = sessions
    ids = j.record(jsess)
    try:
        base = dict(max_new_tokens=10, eos_token_ids=())
        jtext = jsess.answer(Q, j.gen.GenerationConfig(**base, **kw))
        got = tsess.answer_tokens(*tsess._published, Q,
                                  GenerationConfig(**base, **kw))
    finally:
        del jsess.generator.generate
    assert got == ids[-1] and len(got) == 10
    assert tsess.answer(Q, GenerationConfig(**base, **kw)) == jtext
    if "temperature" not in kw:
        assert got == tsess.answer_tokens(*tsess._published, Q,
                                          GenerationConfig(**base))


@pytest.fixture(scope="module")
def sessions4(j):
    """clip_size 4 with partial clips; after every ingest the snapshots of
    both sessions and the greedy answer of each on JAX's snapshot (the
    snapshots agree to bf16 rounding, and on random weights that moves
    near-tied logits: the answer path is held on equal inputs)."""
    jsess, tsess = j.pair(**KW4)
    rng = np.random.default_rng(1)
    scenes = rng.integers(0, 256, size=(3, 112, 112, 3))
    jgen = j.gen.GenerationConfig(max_new_tokens=6, eos_token_ids=())
    gen = GenerationConfig(max_new_tokens=6, eos_token_ids=())
    steps = []
    for i, n in enumerate(CLIPS4):
        frames = _frames(rng, scenes, i, n)
        jsess.ingest_frames(frames)
        tsess.ingest_frames(frames)
        jsnap, jn = jsess._published
        tsnap, tn = tsess._published
        steps.append(dict(
            n=tn, jn=jn, want=j.jax.tree.map(np.asarray, jsnap),
            state=type(tsess.state)(*[x.clone() if isinstance(x, torch.Tensor)
                                      else x for x in tsess.state]),
            got=_snap_np(tsnap), jids=jsess._answer_fused(jsnap, jn, Q, jgen),
            tids=tsess.answer_tokens(_snap_torch(jsnap, tsnap), tn, Q, gen),
            buckets=(tsess._prompt_host(Q, tn)["t_dam"],
                     tsess._prompt_host(Q, tn)["t_csm"])))
    return jsess, tsess, steps


def test_clip4_partial_clips_before_saturation(sessions4):
    """Every ingest's snapshot agrees, and so does the greedy answer (token
    ids) on the same snapshot; the early answers run on padded memory
    buckets and the last after the bank wrapped."""
    _, tsess, steps = sessions4
    fm = tsess.cfg.flash_memory
    assert [s["n"] for s in steps] == [s["jn"] for s in steps] == list(
        np.cumsum([-(-n // 2) for n in CLIPS4]))
    for i, s in enumerate(steps):
        _check_snapshot(s["want"], s["got"], f"ingest {i}", s["state"])
        assert s["tids"] == [int(t) for t in s["jids"]], f"ingest {i}"
    padded = [s for s in steps if s["n"] < fm.csm_grid_len]
    assert padded and any(b != (fm.dam_grid_len, fm.csm_grid_len)
                          for b in (s["buckets"] for s in padded))
    assert steps[-1]["n"] > KW4["bank_size"]      # the ring bank wrapped


def test_clone_fresh_keeps_state_independent(sessions, j):
    _, tsess, _ = sessions
    before = {k: v.clone() for k, v in tsess.state._asdict().items()
              if isinstance(v, torch.Tensor)}
    published, step = tsess._published, tsess._step
    c = tsess.clone_fresh()
    assert c.model is tsess.model and c.generator is tsess.generator
    assert c.tokenizer is tsess.tokenizer and c.metrics is not tsess.metrics
    assert c._published == (None, 0) and c._step == 0 and c.n_frames == 0
    for k, v in c.state._asdict().items():
        if isinstance(v, torch.Tensor):
            assert v.data_ptr() != getattr(tsess.state, k).data_ptr(), k
    rng = np.random.default_rng(7)
    for _ in range(3):
        c.ingest_frames([rng.integers(0, 256, (112, 112, 3), dtype=np.uint8)
                         for _ in range(2)])
    assert c.n_frames == 3 and tsess._published is published
    assert tsess._step == step
    for k, v in before.items():
        assert torch.equal(getattr(tsess.state, k), v), k
    assert c.answer(Q, GenerationConfig(max_new_tokens=2)) is not None


def test_save_resume_round_trip(sessions, tmp_path):
    _, tsess, _ = sessions
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
    frames = [np.full((112, 112, 3), 90, np.uint8)] * 2
    other = tsess.clone_fresh()
    other.load_session(path)
    fresh.ingest_frames(frames)
    other.ingest_frames(frames)
    assert fresh.n_frames == tsess.n_frames + 1
    for a, b in zip(fresh._published[0], other._published[0]):
        assert torch.equal(a, b)
    # an empty stream saves and loads too
    empty = tsess.clone_fresh()
    empty.load_session(empty.save_session(str(tmp_path / "e.pt")))
    assert empty._published == (None, 0)


def test_resume_shape_mismatch_raises(sessions, tmp_path):
    _, tsess, _ = sessions
    path = tsess.save_session(str(tmp_path / "s.pt"))
    other = QwenStreamSession(tsess.model, tsess.tokenizer,
                              **dict(KW, bank_size=8))
    with pytest.raises(ValueError, match="'bank'"):
        other.load_session(path)


@pytest.mark.parametrize("real,cap,want", [(1, 30, 7), (8, 30, 15),
                                           (16, 30, 30), (30, 30, 30),
                                           (3, 60, 15), (61, 60, 60)])
def test_bucket_up(real, cap, want, j):
    assert bucket_up(real, cap) == j.streaming.bucket_up(real, cap) == want


@pytest.mark.gpu
def test_preemptible_and_speculative_answers_on_card():
    """On the card, a small bf16 model (head dims 80 and 128, GQA, M-RoPE):
    the preemptible answer (decode chunks, and prefill chunks whose first
    launches K1) and the speculative one are the greedy ids."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (sm_90a)")
    import dataclasses
    from flash_vstream_tpu_torch.core.config import VStreamQwenConfig
    from flash_vstream_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda)
    from flash_vstream_tpu_torch.models.vstream_qwen import init_qwen_params
    full = VStreamQwenConfig()
    cfg = full.replace(
        vit=dataclasses.replace(full.vit, hidden_size=160,
                                intermediate_size=320, num_layers=2,
                                num_heads=2, merger_out_dim=256),
        llm=dataclasses.replace(full.llm, vocab_size=512, hidden_size=256,
                                intermediate_size=512, num_layers=2,
                                num_heads=2, num_kv_heads=1),
        flash_memory=dataclasses.replace(full.flash_memory,
                                         temporal_length=8, spatial_length=4))
    dev = torch.device("cuda")
    params = init_qwen_params(cfg, torch.Generator(device=dev).manual_seed(0),
                              dev, dtype=torch.bfloat16)
    sess = QwenStreamSession(VStreamQwen(cfg, params),
                             make_byte_qwen_tokenizer(), frame_hw=(112, 112),
                             clip_size=2, bank_size=16, max_len=1024)
    rng = np.random.default_rng(0)
    for _ in range(5):
        sess.ingest_frames([rng.integers(0, 256, (112, 112, 3),
                                         dtype=np.uint8) for _ in range(2)])
    base = dict(max_new_tokens=16, eos_token_ids=())
    greedy = sess.answer_tokens(*sess._published, Q, GenerationConfig(**base))
    n0 = flash_attention_cuda.launches
    for kw in (dict(preemptible_chunk=4), dict(preemptible_chunk=4,
                                               prefill_chunk=64),
               dict(speculative_k=4, speculative_ngram=2)):
        got = sess.answer_tokens(*sess._published, Q,
                                 GenerationConfig(**base, **kw))
        assert got == greedy, kw
    assert flash_attention_cuda.launches > n0
