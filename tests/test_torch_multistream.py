"""Multi-stream serving of the port against the JAX engines on the CPU, the
threaded ingest, and the kernel library's build lock.

- `QwenMultiStreamEngine`: 3 streams of 56 px, bank 16, clip 2, the JAX
  engine's per-stream draws (split(PRNGKey(step), 3)[s]); ragged ticks
  and an empty clip; the bank wraps. After every tick each stream's
  snapshot is held to JAX's (positions equal, an exact DAM tie accepted;
  features within FEATURE_ATOL, the bf16 ViT), and `answer` / `answer_all`
  give JAX's ids (both the batched path and the per-stream fallback when
  the memory buckets differ), `answer_all` the per-stream answers. Once
  more under the drop method.
- `MultiStreamEngine` (LLaVA): 3 streams at clip 2, ragged; every state
  field within 1e-5 (f32), a key frame taken at an exact tie accepted,
  and the ids of `answer` / `answer_all` JAX's.

Both engines are answered on JAX's snapshots: the memories agree to
rounding (bf16 in the Qwen ViT), which can flip the near-tied logits of
random weights, as tests/test_torch_streaming.py found for one stream.
- `ThreadedIngestor`: at fps 0 with answers running on this thread, the
  same frames, count and final snapshot as a sequential session; `stop()`
  mid-stream joins both threads.
"""
import dataclasses
import threading
import time
import types

import numpy as np
import pytest
import torch
from flash_ties import dam_tie

from flash_vstream_tpu_torch.core.config import (tiny_llava_config,
                                                 tiny_qwen_config)
from flash_vstream_tpu_torch.kernels import _build
from flash_vstream_tpu_torch.models.star_memory import STARMemory
from flash_vstream_tpu_torch.models.vstream_qwen import VStreamQwen
from flash_vstream_tpu_torch.ops.pooling import spatial_pool
from flash_vstream_tpu_torch.ops.retrieval import topk_by_weight
from flash_vstream_tpu_torch.preprocess.qwen_processor import (
    make_byte_qwen_tokenizer)
from flash_vstream_tpu_torch.preprocess.tokenizer import ByteTokenizer
from flash_vstream_tpu_torch.runtime import streaming as tst
from flash_vstream_tpu_torch.runtime.generation import GenerationConfig

torch.set_num_threads(1)

FEATURE_ATOL = 5e-2          # the bf16 ViT, as tests/test_torch_streaming.py
BF16_TIE = 1e-2              # an exact DAM tie, up to that ViT's rounding
STAR_ATOL = 1e-5
N = 3
SIDE = 56
KW = dict(frame_hw=(SIDE, SIDE), clip_size=2, bank_size=16, max_len=512)
QS = ("What?", "Where is it?", "Describe the scene now.")
# frames per stream and tick: a partial clip, an empty clip, 19 ticks so
# that the 16-pair banks wrap
TICKS = [(2, 2, 2), (2, 1, 0), (2, 2, 2)] + [(2, 2, 2)] * 4 + [(2, 2, 1)] \
    + [(2, 2, 2)] * 11


class J:
    """The JAX package's pieces, imported on first use."""

    def __init__(self):
        jax = pytest.importorskip("jax")
        from flash_vstream_tpu.core.config import tiny_qwen_config as jqcfg
        from flash_vstream_tpu.models.vstream_qwen import init_qwen_params
        from flash_vstream_tpu.preprocess.qwen_processor import (
            make_byte_qwen_tokenizer as jqtok)
        from flash_vstream_tpu.runtime import generation, streaming
        from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy
        self.jax, self.jqcfg, self.jqtok = jax, jqcfg, jqtok
        self.gen, self.streaming = generation, streaming
        self.from_numpy = params_from_numpy
        self.qparams = init_qwen_params(jax.random.PRNGKey(1), jqcfg())

    def stream_draws(self, n_streams):
        """The JAX engines' draws of stream s at ingest `step`."""
        jax = self.jax

        def draws(step, s, n):
            key = jax.random.split(jax.random.PRNGKey(step), n_streams)[s]
            return torch.from_numpy(np.array(jax.random.uniform(key, (n,))))
        return draws

    def tparams(self, jparams):
        return self.from_numpy(self.jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def j():
    return J()


def _frames(rng, scenes, k, n):
    """n frames of scene k // 3 with noise: clustering has structure."""
    return [np.clip(scenes[(k // 3) % len(scenes)]
                    + rng.integers(-48, 49, scenes[0].shape), 0, 255)
            .astype(np.uint8) for _ in range(n)]


def _clips(seed, ticks, side=SIDE):
    """Each stream its own scenes; clips per tick as `ticks` says."""
    rngs = [np.random.default_rng(seed + s) for s in range(N)]
    scenes = [r.integers(0, 256, size=(3, side, side, 3)) for r in rngs]
    out = []
    for k, sizes in enumerate(ticks):
        out.append([_frames(rngs[s], scenes[s], k, n)
                    for s, n in enumerate(sizes)])
    return out


def _recorder(obj, name):
    """Record the ids each call of obj.name returns."""
    ids, fn = [], getattr(obj, name)

    def recorded(*a, **k):
        out = fn(*a, **k)
        ids.append(np.asarray(out).tolist() if name != "generate_batch"
                   else [list(map(int, o)) for o in out])
        return out
    setattr(obj, name, recorded)
    return ids


# ---------------------------------------------------------------------------
# the kernel library's build lock
# ---------------------------------------------------------------------------

def test_library_builds_once_from_two_threads(monkeypatch, tmp_path):
    """Two threads reaching their first kernel at once: one build, one
    load, the same library in both."""
    builds = []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)
        return tmp_path / "lib.so"

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    got = []
    threads = [threading.Thread(target=lambda: got.append(_build.library()))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1 and len(got) == 2 and got[0] is got[1]


# ---------------------------------------------------------------------------
# QwenMultiStreamEngine
# ---------------------------------------------------------------------------

def _check_stream(jsnaps, s, got, state, msg):
    """Stream s's snapshot against the JAX engine's stacked one."""
    spa_pos, tem_pos, spa_x, tem_x = (np.asarray(x[s], np.float32)
                                      for x in jsnaps)
    np.testing.assert_array_equal(got[1].numpy(), tem_pos, err_msg=msg)
    np.testing.assert_allclose(got[3].float().numpy(), tem_x,
                               atol=FEATURE_ATOL, err_msg=msg)
    for k, (a, b) in enumerate(zip(got[0].tolist(), spa_pos.tolist())):
        if a == b:
            np.testing.assert_allclose(got[2][k].float().numpy(), spa_x[k],
                                       atol=FEATURE_ATOL, err_msg=msg)
        else:
            assert dam_tie(state, len(spa_pos), k, int(a), int(b),
                           BF16_TIE), (msg, k)


def _f32_snapshots(j, jeng):
    """The JAX engine's snapshots with their features in f32, and the same
    as the port's per-stream tuples: both mergers then run in f32 (over
    bf16 rows XLA fuses elementwise ops that torch rounds one by one, and
    the near-tied logits of random weights can flip, as
    tests/test_torch_pipeline.py found)."""
    import jax.numpy as jnp
    jsnaps = tuple(x.astype(jnp.float32) if x.dtype != jnp.int32 else x
                   for x in jeng._snapshots)
    port = [tuple(torch.from_numpy(np.array(x[s])) for x in jsnaps)
            for s in range(N)]
    return jsnaps, port


def _qwen_pair(j, cfg_fn=None):
    jcfg, tcfg = j.jqcfg(), tiny_qwen_config()
    if cfg_fn is not None:
        jcfg, tcfg = cfg_fn(jcfg), cfg_fn(tcfg)
    jeng = j.streaming.QwenMultiStreamEngine(
        j.qparams, jcfg, j.jqtok(), n_streams=N, **KW)
    teng = tst.QwenMultiStreamEngine(
        VStreamQwen(tcfg, j.tparams(j.qparams)), make_byte_qwen_tokenizer(),
        N, draws=j.stream_draws(N), **KW)
    return jeng, teng


def _run_qwen(j, ticks, seed, cfg_fn=None, answer_at=()):
    """Both engines over the same ticks; after each tick every stream's
    snapshot is checked, and at the ticks in `answer_at` every stream is
    answered alone and all together in both packages."""
    jeng, teng = _qwen_pair(j, cfg_fn)
    jfused = _recorder(jeng.sess, "_answer_fused")
    jbatch = _recorder(jeng.sess.generator, "generate_batch")
    tone = _recorder(teng.sess, "answer_tokens")
    tbatch = _recorder(teng.sess.generator, "generate_batch")
    jgen = j.gen.GenerationConfig(max_new_tokens=5, eos_token_ids=())
    gen = GenerationConfig(max_new_tokens=5, eos_token_ids=())
    answers = []
    for k, clips in enumerate(_clips(seed, ticks)):
        jeng.ingest(clips)
        teng.ingest(clips)
        assert list(teng.n_frames) == jeng._n_frames
        for s in range(N):
            state = tst._stream_view(teng.states, s, teng.n_frames[s])
            _check_stream(jeng._snapshots, s, teng._published[0][s], state,
                          f"tick {k} stream {s}")
        if k in answer_at:
            # both answered on JAX's snapshots in f32: the two agree to
            # bf16 rounding, which can flip near-tied logits of random
            # weights (as in tests/test_torch_streaming.py)
            jeng._snapshots, snaps = _f32_snapshots(j, jeng)
            teng._published = (snaps, teng._published[1])
            del jfused[:], jbatch[:], tone[:], tbatch[:]
            jall = jeng.answer_all(list(QS), jgen)
            tall = teng.answer_all(list(QS), gen)
            jone = [jeng.answer(i, q, jgen) for i, q in enumerate(QS)]
            tsingle = [teng.answer(i, q, gen) for i, q in enumerate(QS)]
            answers.append(dict(jall=jall, tall=tall, jone=jone,
                                tone=tsingle, jfused=list(jfused),
                                jbatch=list(jbatch), tids=list(tone),
                                tbatch=list(tbatch)))
    return jeng, teng, answers


@pytest.fixture(scope="module")
def qwen_run(j):
    # tick 2 (3, 3, 2 frame pairs): the CSM buckets differ (per-stream
    # fallback); the last tick: batched
    return _run_qwen(j, TICKS, 0, answer_at=(2, len(TICKS) - 1))


def test_qwen_engine_snapshots_match_jax(qwen_run):
    jeng, teng, _ = qwen_run
    assert list(teng.n_frames) == [19, 19, 18] == jeng._n_frames
    assert int(teng.states.bank_pos.max()) == 18          # the banks wrapped
    assert not torch.allclose(teng.states.tem_x[0], teng.states.tem_x[1])


def test_qwen_engine_answers_match_jax(qwen_run):
    _, _, answers = qwen_run
    fallback, batched = answers
    # tick 2: the streams' buckets differ, both engines answer per stream
    assert not fallback["jbatch"] and not fallback["tbatch"]
    assert batched["jbatch"] and batched["tbatch"]
    for a in answers:
        assert a["tall"] == a["jall"] and a["tone"] == a["jone"]
        assert a["tall"] == a["tone"]
        # the per-stream ids (answer, and answer_all's fallback) are JAX's
        assert a["tids"] == a["jfused"]
        assert a["tbatch"] == a["jbatch"]
    assert batched["tbatch"][0] == batched["tids"]


def test_qwen_engine_drop_method_matches_jax(j):
    """A temporal method outside the k-means family (drop: sequential, with
    coins from the per-stream draws), ragged ticks included."""
    def drop(cfg):
        return dataclasses.replace(cfg, flash_memory=dataclasses.replace(
            cfg.flash_memory, temporal_method="drop"))
    ticks = [(2, 2, 2), (2, 1, 0), (2, 2, 2), (1, 2, 2), (2, 2, 2),
             (2, 2, 2), (2, 2, 2)]
    _, teng, answers = _run_qwen(j, ticks, 5, drop, answer_at=(6,))
    a = answers[0]
    assert a["tall"] == a["jall"] == a["jone"]
    assert a["tbatch"] == a["jbatch"]
    assert list(teng.n_frames) == [7, 7, 6]


def test_qwen_engine_batch_uses_one_gather(j, monkeypatch):
    """Every stream's DAM rows come out of one batched gather a tick."""
    calls = []
    real = tst.gather_rows_batched
    monkeypatch.setattr(tst, "gather_rows_batched",
                        lambda b, i: calls.append(tuple(i.shape)) or real(b, i))
    _, teng = _qwen_pair(j)
    for clips in _clips(1, [(2, 2, 2), (2, 0, 1)]):
        teng.ingest(clips)
    assert calls == [(N, 2), (N, 2)]


# ---------------------------------------------------------------------------
# MultiStreamEngine (LLaVA)
# ---------------------------------------------------------------------------

def _check_key_frames(teng, got, want, msg):
    """Key frames equal, or taken at an exact retrieval tie: the query
    cluster as near to the port's frame as to JAX's (a cluster of two
    equal-weight frames sits midway between them)."""
    star = teng.cfg.star
    for s in range(N):
        state = tst._stream_view(teng.states, s, teng.n_frames[s])
        for slot in range(star.key_length):
            a, b = got[s, slot], want[s, slot]
            if np.abs(a - b).max() <= STAR_ATOL:
                continue
            q = state.long.reshape(star.long_length, -1)[topk_by_weight(
                state.long_weights, star.key_length)[slot]]

            def dist(rows):
                f = spatial_pool(torch.from_numpy(rows), star.long_size)
                return float(((f.reshape(-1) - q) ** 2).sum())
            assert abs(dist(a) - dist(b)) <= 1e-4 * max(dist(a), dist(b)), (
                msg, s, slot)


def test_llava_engine_matches_jax(j):
    from flash_vstream_tpu.core.config import tiny_llava_config as jlcfg
    from flash_vstream_tpu.models import star_memory as jstar
    from flash_vstream_tpu.models.vstream_llava import init_llava_params
    from flash_vstream_tpu.preprocess.tokenizer import ByteTokenizer as JB
    jax = j.jax
    jparams = init_llava_params(jax.random.PRNGKey(0), jlcfg())
    jeng = j.streaming.MultiStreamEngine(jparams, jlcfg(), JB(), n_streams=N,
                                         clip_size=2, max_len=512)
    teng = tst.MultiStreamEngine(j.tparams(jparams), tiny_llava_config(),
                                 ByteTokenizer(), N, clip_size=2, max_len=512,
                                 draws=j.stream_draws(N))
    ticks = [(2, 2, 2), (2, 1, 0), (2, 2, 2), (1, 2, 2), (2, 2, 2)]
    for k, clips in enumerate(_clips(3, ticks, side=112)):
        jeng.ingest(clips)
        teng.ingest(clips)
        for name, got in teng.states._asdict().items():
            want = np.asarray(getattr(jeng.states, name)).astype(np.float32)
            if name == "n_frames":
                assert list(teng.n_frames) == want.tolist()
                continue
            got = got.float().numpy()
            if name == "key_frames":
                _check_key_frames(teng, got, want, f"tick {k}")
                continue
            np.testing.assert_allclose(got, want, atol=STAR_ATOL,
                                       err_msg=f"tick {k} {name}")
    # answered on JAX's memory: a key frame taken at an exact tie changes
    # the prompt
    mem = [jstar.star_memory_tokens(jlcfg().star, jax.tree.map(
        lambda x, s=s: x[s], jeng.states)) for s in range(N)]
    teng._published = ([STARMemory(torch.from_numpy(np.array(m.tokens)),
                                   torch.from_numpy(np.array(m.valid)))
                        for m in mem], teng._published[1])
    jone = _recorder(jeng.generator, "generate")
    jbatch = _recorder(jeng.generator, "generate_batch")
    tone = _recorder(teng.generator, "generate")
    tbatch = _recorder(teng.generator, "generate_batch")
    jgen = j.gen.GenerationConfig(max_new_tokens=6, eos_token_ids=())
    gen = GenerationConfig(max_new_tokens=6, eos_token_ids=())
    want = [jeng.answer(i, q, jgen) for i, q in enumerate(QS)]
    got = [teng.answer(i, q, gen) for i, q in enumerate(QS)]
    assert tone == jone and got == want
    assert teng.answer_all(list(QS), gen) == jeng.answer_all(list(QS), jgen)
    assert tbatch == jbatch and tbatch[0] == tone


# ---------------------------------------------------------------------------
# ThreadedIngestor
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model(j):
    return VStreamQwen(tiny_qwen_config(), j.tparams(j.qparams))


def _session(model):
    return tst.QwenStreamSession(model, make_byte_qwen_tokenizer(), **KW)


def test_threaded_ingest_equals_sequential(model):
    """fps 0, answers running here meanwhile: every frame ingested, and the
    count and final snapshot a sequential session's, bit for bit."""
    frames = [f for clip in _clips(7, [(2, 2, 2)] * 6)
              for f in clip[0]]
    sess, ref = _session(model), _session(model)
    gen = GenerationConfig(max_new_tokens=3, eos_token_ids=())
    ing = tst.ThreadedIngestor(sess, frames, fps=0, clip_size=2).start()
    answered = 0
    while not ing.wait(timeout=0.001):
        if sess.n_frames > 0:
            assert isinstance(sess.answer("Q?", gen), str)
            answered += 1
    for i in range(0, len(frames), 2):
        ref.ingest_frames(frames[i:i + 2])
    assert ing.error is None and ing.missed_deadlines == 0
    assert ing.frames_ingested == 12 and sess.n_frames == ref.n_frames == 6
    for a, b in zip(sess._published[0], ref._published[0]):
        assert torch.equal(a, b)
    assert not ing._thread.is_alive() and not ing._watcher.is_alive()


def test_threaded_ingest_stop_joins_both_threads(model):
    frames = [np.zeros((SIDE, SIDE, 3), np.uint8)] * 40
    ing = tst.ThreadedIngestor(_session(model), frames, fps=20,
                               clip_size=2).start()
    while ing.frames_ingested == 0:
        time.sleep(0.005)
    ing.stop()
    assert not ing._thread.is_alive() and not ing._watcher.is_alive()
    assert 0 < ing.frames_ingested < 40
    assert ing.wait(timeout=0)
