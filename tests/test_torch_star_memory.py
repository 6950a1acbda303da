"""The port's STAR memory and its ops held against the JAX package.

Pooling, `star_retrieve`, all of ops/sequential.py (the drop ops' coins are
JAX's `jax.random.bernoulli` draws), ops/ntm.py, `star_consolidate` and
`star_stream_update` over a bank that wraps, with JAX's `jax.random.uniform`
draws for the k-means init. Inputs are made with numpy from a seed; both
sides run in f32. Tolerances: 1e-5 absolute on values of order one (f32
sums taken in another order), exact on indices, validity and counts. The
one deviation accepted is an exact retrieval tie: a cluster of two
equal-weight frames has its centroid at their midpoint, the two frames are
equally near, and either may be retrieved (`_key_slots_agree`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_vstream_tpu.core.config import STARConfig as JSTARConfig
from flash_vstream_tpu.models import star_memory as jstar
from flash_vstream_tpu.ops import ntm as jntm
from flash_vstream_tpu.ops import pooling as jpool
from flash_vstream_tpu.ops import retrieval as jret
from flash_vstream_tpu.ops import sequential as jseq
from flash_vstream_tpu_torch.core.config import STARConfig
from flash_vstream_tpu_torch.models import star_memory as tstar
from flash_vstream_tpu_torch.ops import ntm as tntm
from flash_vstream_tpu_torch.ops import pooling as tpool
from flash_vstream_tpu_torch.ops import retrieval as tret
from flash_vstream_tpu_torch.ops import sequential as tseq
from flash_vstream_tpu_torch.ops.distances import sq_euclidean_distance

torch.set_num_threads(1)

ATOL = 1e-5
KW = dict(long_length=4, long_size=2, turing_length=3, turing_size=1,
          current_size=4, key_length=2, turing_hidden_dim=8,
          video_max_frames=16, max_frames_static=16)
D = 16
P = 16


def t(x):
    return torch.from_numpy(np.array(x))


def draws_of(key):
    """The port's draw function for a JAX key: n -> uniform(key, (n,))."""
    return lambda n: t(jax.random.uniform(key, (n,)))


def coins_of(key, n):
    return t(jax.random.bernoulli(key, 0.5, (n,)))


def close(got, want, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=0, err_msg=msg)


def ntm_pair(seed=0, din=D, h=8):
    jp = jntm.init_ntm_params(jax.random.PRNGKey(seed), din, h)
    return jp, tntm.NTMParams(*(t(f) for f in jp))


# ---------------------------------------------------------------------------
# pooling and retrieval
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,out", [(8, 8), (8, 4), (8, 2), (8, 1), (16, 4),
                                   (4, 2)])
def test_spatial_pool_matches_jax(rng, p, out):
    x = rng.normal(size=(3, p * p, 5)).astype(np.float32)
    got = tpool.spatial_pool(t(x), out)
    want = jpool.spatial_pool(jnp.asarray(x), out)
    assert got.shape == want.shape
    close(got, want, 1e-6)


def test_merge_2x2_tokens_matches_jax(rng):
    x = rng.normal(size=(2, 64, 6)).astype(np.float32)
    np.testing.assert_array_equal(tpool.merge_2x2_tokens(t(x)).numpy(),
                                  np.asarray(jpool.merge_2x2_tokens(
                                      jnp.asarray(x))))


def test_star_retrieve_matches_jax(rng):
    L, Dp, T = 5, 6, 12
    for trial in range(4):
        cents = rng.normal(size=(L, Dp)).astype(np.float32) * 3
        w = rng.integers(1, 4, L).astype(np.float32)    # tied weights too
        bank = rng.normal(size=(T, Dp)).astype(np.float32) * 3
        valid = rng.random(T) < 0.8
        valid[0] = True
        got = tret.star_retrieve(t(cents), t(w), t(bank), t(valid), 3)
        want = jret.star_retrieve(jnp.asarray(cents), jnp.asarray(w),
                                  jnp.asarray(bank), jnp.asarray(valid), 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.int32
    # the JAX test's case: the two heaviest clusters' own frames
    centroids = rng.normal(size=(4, Dp)).astype(np.float32) * 5
    bank = np.concatenate([centroids + 0.01,
                           rng.normal(size=(6, Dp)).astype(np.float32) * 20])
    idx = tret.star_retrieve(t(centroids), t(np.array([1., 9., 3., 2.],
                                                      np.float32)),
                             t(bank), torch.ones(10, dtype=torch.bool), 2)
    assert idx.tolist() == [1, 2]


# ---------------------------------------------------------------------------
# ops/sequential.py
# ---------------------------------------------------------------------------

SEQ_CASES = [(12, 12, 4), (12, 7, 4), (12, 3, 4), (9, 9, 9), (16, 16, 5)]


def _seq_input(rng, Tmax, Dx=8):
    # drifting frames: neighbours are similar, so merges and drops vary
    x = np.cumsum(rng.normal(size=(Tmax, Dx)), axis=0).astype(np.float32)
    return x


@pytest.mark.parametrize("Tmax,n,t0", SEQ_CASES)
@pytest.mark.parametrize("op", ["merge", "kmerge", "drop", "kdrop"])
def test_sequential_ops_match_jax(rng, op, Tmax, n, t0):
    x = _seq_input(rng, Tmax)
    key = jax.random.PRNGKey(Tmax + n)
    coins = coins_of(key, Tmax - t0)
    jx = jnp.asarray(x)
    if op == "merge":
        got, want = tseq.merge_frames(t(x), n, t0), jseq.merge_frames(
            jx, jnp.int32(n), t0)
    elif op == "kmerge":
        got, want = tseq.k_merge_frames(t(x), n, t0), jseq.k_merge_frames(
            jx, jnp.int32(n), t0)
    elif op == "drop":
        got = tseq.drop_frames(t(x), n, t0, coins)
        want = jseq.drop_frames(jx, jnp.int32(n), t0, key)
    else:
        got = tseq.k_drop_frames(t(x), n, t0, coins)
        want = jseq.k_drop_frames(jx, jnp.int32(n), t0, key)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    close(got.features, want.features, 1e-4)
    close(got.aux, want.aux, 1e-5)


@pytest.mark.parametrize("Tmax,n,t0", SEQ_CASES)
@pytest.mark.parametrize("op", ["merge", "drop"])
def test_timed_sequential_ops_match_jax(rng, op, Tmax, n, t0):
    x = _seq_input(rng, Tmax)
    times = (np.arange(Tmax) * 1.5).astype(np.float32)
    w = rng.uniform(0.5, 2.0, Tmax).astype(np.float32)
    key = jax.random.PRNGKey(n)
    for tt, ww in ((None, None), (times, w)):
        jt = None if tt is None else jnp.asarray(tt)
        jw = None if ww is None else jnp.asarray(ww)
        ptt = None if tt is None else t(tt)
        pww = None if ww is None else t(ww)
        if op == "merge":
            got = tseq.merge_frames_timed(t(x), n, t0, ptt, pww)
            want = jseq.merge_frames_timed(jnp.asarray(x), jnp.int32(n), t0,
                                           jt, jw)
        else:
            got = tseq.drop_frames_timed(t(x), n, t0,
                                         coins_of(key, Tmax - t0), ptt, pww)
            want = jseq.drop_frames_timed(jnp.asarray(x), jnp.int32(n), t0,
                                          key, jt, jw)
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(want.valid))
        close(got.features, want.features, 1e-4)
        close(got.weights, want.weights, 1e-5)
        close(got.times, want.times, 1e-4)


@pytest.mark.parametrize("n,t0", [(1, 4), (5, 4), (7, 3), (16, 16), (40, 9),
                                  (13, 7), (100, 25)])
def test_sample_frames_matches_jax(rng, n, t0):
    x = rng.normal(size=(max(n, t0), 3)).astype(np.float32)
    got, idx = tseq.sample_frames(t(x), n, t0)
    wantx, widx = jseq.sample_frames(jnp.asarray(x), jnp.int32(n), t0)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(wantx))


def test_merge_short_input_passes_through(rng):
    """n_valid <= t0: no step runs, the first t0 rows come back."""
    x = _seq_input(rng, 10)
    r = tseq.merge_frames(t(x), 3, 5)
    np.testing.assert_array_equal(r.features.numpy(), x[:5])
    assert r.valid.tolist() == [True] * 3 + [False] * 2


# ---------------------------------------------------------------------------
# ops/ntm.py
# ---------------------------------------------------------------------------

def test_ntm_update_matches_jax(rng):
    jp, tp = ntm_pair()
    mem = rng.normal(size=(6, D)).astype(np.float32)
    new = rng.normal(size=(9, D)).astype(np.float32)
    for valid in (None, rng.random(9) < 0.5, np.zeros(9, bool)):
        jv = None if valid is None else jnp.asarray(valid)
        tv = None if valid is None else t(valid)
        got = tntm.ntm_update(tp, t(mem), t(new), tv, 0.3)
        want = jntm.ntm_update(jp, jnp.asarray(mem), jnp.asarray(new), jv,
                               0.3)
        close(got, want)
    # no valid key: the memory comes back unchanged
    np.testing.assert_array_equal(
        tntm.ntm_update(tp, t(mem), t(new), torch.zeros(9, dtype=torch.bool)
                        ).numpy(), mem)


@pytest.mark.parametrize("Tmax,n", [(16, 16), (16, 11), (16, 3), (17, 17),
                                    (12, 1)])
def test_ntm_compress_matches_jax(rng, Tmax, n):
    jp, tp = ntm_pair(1)
    x = rng.normal(size=(Tmax, 2, D)).astype(np.float32)
    got = tntm.ntm_compress(tp, t(x), n, 3, 2, 0.2)
    want = jntm.ntm_compress(jp, jnp.asarray(x), jnp.int32(n), 3, 2, 0.2)
    assert got.shape == (3, 2, D)
    close(got, want)


def test_init_ntm_params_distribution():
    p = tntm.init_ntm_params(torch.Generator().manual_seed(0), 64, 32)
    jp = jntm.init_ntm_params(jax.random.PRNGKey(0), 64, 32)
    for a, b in zip(p, jp):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    bound = 1 / 8.0
    assert float(p.wq.abs().max()) <= bound and float(p.wq.std()) > 0.5 * (
        bound / 3 ** 0.5)
    assert not p.bq.any() and bool((p.ln_scale == 1).all())


# ---------------------------------------------------------------------------
# STAR memory
# ---------------------------------------------------------------------------

def _scene_feats(rng, T, Tmax, n_scenes=3):
    """Pooled frame features of a few scenes with noise: clustering has
    structure (i.i.d. frames would cluster by rounding noise)."""
    scenes = rng.normal(size=(n_scenes, P, D)) * 2
    x = np.zeros((Tmax, P, D), np.float32)
    for i in range(T):
        x[i] = scenes[(i * n_scenes) // max(T, 1)] + 0.3 * rng.normal(
            size=(P, D))
    return x


def _key_slots_agree(got_tokens, want_tokens, got_valid, sections, pooled,
                     queries, long_size, msg):
    """Key-frame slots equal, or an exact tie: the frames both sides took
    are equally near the slot's query (relative 1e-4)."""
    n_before, P_cur, k = sections
    ties = 0
    for j in range(k):
        a = slice(n_before + j * P_cur, n_before + (j + 1) * P_cur)
        g, w = np.asarray(got_tokens[a]), np.asarray(want_tokens[a])
        if np.abs(g - w).max() <= 1e-4 or not got_valid[a].any():
            continue
        q = torch.as_tensor(queries[j])[None].float()
        dg = float(sq_euclidean_distance(q, tpool.spatial_pool(
            torch.as_tensor(g), long_size).reshape(1, -1).float()))
        dw = float(sq_euclidean_distance(q, tpool.spatial_pool(
            torch.as_tensor(w), long_size).reshape(1, -1).float()))
        assert abs(dg - dw) <= 1e-4 * max(dg, dw, 1e-6), (msg, j, dg, dw)
        ties += 1
    return ties


def _queries(cfg, long_mem, weights):
    top = tret.topk_by_weight(torch.as_tensor(np.array(weights)),
                              cfg.key_length)
    return torch.as_tensor(np.array(long_mem)).reshape(
        cfg.long_length, -1)[top].numpy()


def _check_memory(cfg, got, want, long_mem, weights, msg):
    """STARMemory got (port) vs want (JAX): validity equal; Turing, long
    and current sections within ATOL; key slots equal or tied. Returns the
    number of tied key slots."""
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid),
                                  err_msg=msg)
    n_t = cfg.turing_length * cfg.turing_size ** 2
    n_l = cfg.long_length * cfg.long_size ** 2
    Pc = cfg.current_size ** 2
    n_k = cfg.key_length * Pc
    gt, wt = got.tokens.numpy(), np.asarray(want.tokens)
    close(gt[:n_t + n_l], wt[:n_t + n_l], 1e-4, msg)
    close(gt[n_t + n_l + n_k:], wt[n_t + n_l + n_k:], 1e-4, msg)
    return _key_slots_agree(gt, wt, got.valid.numpy(),
                            (n_t + n_l, Pc, cfg.key_length),
                            None, _queries(cfg, long_mem, weights),
                            cfg.long_size, msg)


@pytest.mark.parametrize("compress", ["weighted_kmeans", "merge", "drop",
                                      "kmerge", "kdrop"])
@pytest.mark.parametrize("T", [1, 3, 5, 12, 16])
def test_star_consolidate_matches_jax(rng, compress, T):
    cfg, jcfg = STARConfig(compress_type=compress, **KW), JSTARConfig(
        compress_type=compress, **KW)
    jp, tp = ntm_pair()
    x = _scene_feats(rng, T, 16)
    key = jax.random.PRNGKey(T)
    want = jstar.star_consolidate(jp, jcfg, jnp.asarray(x), jnp.int32(T),
                                  key)
    got = tstar.star_consolidate(tp, cfg, t(x), T, draws_of(key))
    assert got.tokens.shape == (tstar.star_token_count(cfg), D)
    n_hist = max(T - cfg.current_length, 0)
    pooled = jpool.spatial_pool(jnp.asarray(x), cfg.long_size)
    clusters, _, weights = jstar._compress_long(
        jcfg, pooled, jnp.arange(16) < n_hist, jnp.int32(n_hist), key)
    _check_memory(cfg, got, want, clusters, weights, f"T={T}")


def test_star_consolidate_short_video_layout(rng):
    """T 3 (a history of 2 < long_length): 2 Turing and 2 long frames valid,
    the long memory the pooled frames themselves, in order."""
    cfg = STARConfig(**KW)
    _, tp = ntm_pair()
    x = _scene_feats(rng, 3, 16)
    mem = tstar.star_consolidate(tp, cfg, t(x), 3, draws_of(
        jax.random.PRNGKey(0)))
    v = mem.valid.numpy()
    assert v[:3].sum() == 2 and v[3:3 + 16].sum() == 8
    close(mem.tokens[3:3 + 8], tpool.spatial_pool(t(x[:2]), 2).reshape(8, D),
          1e-6)


@pytest.mark.parametrize("compress", ["weighted_kmeans", "merge", "drop",
                                      "kdrop"])
@pytest.mark.parametrize("clip", [2, 3])
def test_star_stream_update_matches_jax_over_a_wrapping_bank(rng, compress,
                                                             clip):
    """Ingest after ingest (the last clip partial), the state and the memory
    tokens agree with JAX's on JAX's draws, before the long memory
    saturates, at saturation and after the 16-frame bank wraps."""
    cfg, jcfg = STARConfig(compress_type=compress, **KW), JSTARConfig(
        compress_type=compress, **KW)
    jp, tp = ntm_pair(2)
    jstate = jstar.init_star_state(jcfg, D)
    tstate = tstar.init_star_state(cfg, D)
    n_total, ties = 0, 0
    clips = [clip] * (24 // clip) + [1]
    scenes = rng.normal(size=(4, P, D)) * 2
    for step, n in enumerate(clips):
        x = np.zeros((clip, P, D), np.float32)
        for i in range(n):
            x[i] = scenes[((n_total + i) // 5) % 4] + 0.3 * rng.normal(
                size=(P, D))
        key = jax.random.PRNGKey(step)
        jstate = jstar.star_stream_update(jp, jcfg, jstate, jnp.asarray(x),
                                          jnp.int32(n), key)
        tstate = tstar.star_stream_update(tp, cfg, tstate, t(x), n,
                                          draws_of(key))
        n_total += n
        msg = f"{compress} clip {clip} step {step}"
        assert tstate.n_frames == int(jstate.n_frames) == n_total
        for f in ("cur_valid", "key_valid", "long_valid", "turing_valid",
                  "bank_pos"):
            np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                          np.asarray(getattr(jstate, f)),
                                          err_msg=f"{msg} {f}")
        for f in ("cur", "long", "long_weights", "turing", "bank"):
            close(getattr(tstate, f), getattr(jstate, f), 1e-4,
                  f"{msg} {f}")
        ties += _check_memory(cfg, tstar.star_memory_tokens(cfg, tstate),
                              jstar.star_memory_tokens(jcfg, jstate),
                              jstate.long, jstate.long_weights, msg)
    assert n_total > cfg.max_frames_static            # the bank wrapped
    assert bool(tstate.long_valid.all()) and bool(tstate.turing_valid.all())


def test_stream_snapshot_is_fresh(rng):
    """A snapshot keeps its values when later ingests write the bank in
    place."""
    cfg = STARConfig(**KW)
    _, tp = ntm_pair()
    state = tstar.init_star_state(cfg, D)
    draws = draws_of(jax.random.PRNGKey(0))
    state = tstar.star_stream_update(tp, cfg, state, t(_scene_feats(
        rng, 2, 2)), 2, draws)
    snap = tstar.star_memory_tokens(cfg, state)
    before = snap.tokens.clone()
    for _ in range(10):
        state = tstar.star_stream_update(tp, cfg, state, t(_scene_feats(
            rng, 2, 2)), 2, draws)
    assert torch.equal(snap.tokens, before)
