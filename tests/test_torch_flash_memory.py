"""The Flash memory of the port against JAX in f32 on the CPU: distances,
k-means, DAM retrieval, AM-RoPE positions, and `flash_stream_update` over
nine clips (the CSM saturates after the third and the ring bank wraps),
comparing state and snapshot after every clip. Tolerances: 1e-5 for single
ops, 1e-4 for the streaming state (ten k-means iterations per clip).

The k-means init is the one place the two cannot share an RNG: the port
takes the uniform draws themselves, so the tests hand it JAX's draws."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_vstream_tpu.core.config import FlashMemoryConfig
from flash_vstream_tpu.models import flash_memory as jfm
from flash_vstream_tpu.ops import distances as jd
from flash_vstream_tpu.ops import kmeans as jk
from flash_vstream_tpu.ops import retrieval as jr
from flash_vstream_tpu_torch.models import flash_memory as tfm
from flash_vstream_tpu_torch.ops import distances as td
from flash_vstream_tpu_torch.ops import kmeans as tk
from flash_vstream_tpu_torch.ops import retrieval as tr

torch.set_num_threads(1)
ATOL = 1e-5
STATE_ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _uniform(key, n):
    return _t(jax.random.uniform(key, (n,)))


@pytest.fixture
def data():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(4, 20)) * 3
    x = (centers[rng.integers(0, 4, 14)] + rng.normal(size=(14, 20)))
    w = rng.uniform(0.5, 2.0, size=14).astype(np.float32)
    valid = np.ones(14, bool)
    valid[[3, 12]] = False
    return x.astype(np.float32), w, valid


def _assert_kmeans(got, want, atol=ATOL):
    for name in ("centroids", "cluster_weights", "timestamps"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), atol=atol,
                                   err_msg=name)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))


def test_distances(data):
    x, _, _ = data
    a, b = x[:5], x[5:]
    np.testing.assert_allclose(
        td.sq_euclidean_distance(_t(a), _t(b)).numpy(),
        np.asarray(jd.sq_euclidean_distance(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-4)
    np.testing.assert_allclose(
        td.cosine_similarity_matrix(_t(a), _t(b)).numpy(),
        np.asarray(jd.cosine_similarity_matrix(jnp.asarray(a),
                                               jnp.asarray(b))), atol=ATOL)
    np.testing.assert_allclose(
        td.euclidean_distance(_t(a), _t(b)).numpy(),
        np.asarray(jd.euclidean_distance(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-4)
    np.testing.assert_allclose(
        td.cosine_similarity(_t(a), _t(x[5:10])).numpy(),
        np.asarray(jd.cosine_similarity(jnp.asarray(a),
                                        jnp.asarray(x[5:10]))), atol=ATOL)


@pytest.mark.parametrize("ordered", [False, True])
def test_weighted_kmeans_with_init(data, ordered):
    x, w, valid = data
    init = x[[0, 5, 9, 13]]
    jfn = jk.weighted_kmeans_ordered if ordered else jk.weighted_kmeans
    tfn = tk.weighted_kmeans_ordered if ordered else tk.weighted_kmeans
    want = jfn(jnp.asarray(x), 4, weights=jnp.asarray(w),
               valid=jnp.asarray(valid), init=jnp.asarray(init))
    got = tfn(_t(x), 4, weights=_t(w), valid=_t(valid), init=_t(init))
    _assert_kmeans(got, want)


def test_weighted_kmeans_init_scores_match_key(data):
    """The JAX init from a key equals the port's init from that key's
    uniform draws."""
    x, w, valid = data
    key = jax.random.PRNGKey(3)
    want = jk.weighted_kmeans(jnp.asarray(x), 5, weights=jnp.asarray(w),
                              valid=jnp.asarray(valid), key=key)
    got = tk.weighted_kmeans(_t(x), 5, weights=_t(w), valid=_t(valid),
                             init_scores=_uniform(key, 14))
    _assert_kmeans(got, want)


def test_weighted_kmeans_repairs_empty_clusters():
    """Identical rows leave clusters empty; both reseed them the same way."""
    x = np.zeros((8, 6), np.float32)
    x[5:] = 1.0
    init = np.stack([x[0], x[0], x[0], x[5]])
    want = jk.weighted_kmeans(jnp.asarray(x), 4, init=jnp.asarray(init))
    got = tk.weighted_kmeans(_t(x), 4, init=_t(init))
    _assert_kmeans(got, want)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_dam_retrieve(metric):
    rng = np.random.default_rng(1)
    tem = rng.normal(size=(6, 4, 8)).astype(np.float32)
    wts = rng.uniform(size=6).astype(np.float32)
    wts[2] = wts[4]                          # a tie: stable order decides
    bank = rng.normal(size=(10, 4, 8)).astype(np.float32)
    bvalid = np.ones(10, bool)
    bvalid[7] = False
    want = jr.dam_retrieve(jnp.asarray(tem), jnp.asarray(wts),
                           jnp.asarray(bank), jnp.asarray(bvalid), 4, metric)
    got = tr.dam_retrieve(_t(tem), _t(wts), _t(bank), _t(bvalid), 4, metric)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def test_am_rope_visual_positions():
    spa = np.array([0, 3, 9], np.int32)
    tem = np.array([1, 2, 5, 8], np.int32)
    want = jfm.am_rope_visual_positions(jnp.asarray(spa), jnp.asarray(tem),
                                        (8, 8), (4, 4))
    got = tfm.am_rope_visual_positions(_t(spa), _t(tem), (8, 8), (4, 4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


SPATIAL = ["klarge_retrieve", "klarge_retrieve_cos", "sample", "nearest"]


@pytest.mark.parametrize("spatial", SPATIAL)
def test_stream_update_every_clip(spatial):
    cfg = dataclasses.replace(FlashMemoryConfig(temporal_length=8,
                                                spatial_length=4),
                              spatial_method=spatial)
    p_full, p_small, D, bank, T_new = 16, 4, 32, 16, 2
    K = cfg.csm_grid_len
    jstate = jfm.init_flash_state(cfg, p_full, p_small, D, bank_size=bank,
                                  bank_dtype=jnp.float32)
    tstate = tfm.flash_state_from_numpy(jax.tree.map(np.asarray, jstate))
    jupdate = jax.jit(jfm.flash_stream_update, static_argnums=(0,))
    rng = np.random.default_rng(2)
    for clip in range(9):
        n_new = 1 if clip == 4 else T_new        # one partial clip
        x = rng.normal(size=(T_new, p_full, D)).astype(np.float32)
        sx = rng.normal(size=(T_new, p_small, D)).astype(np.float32)
        key = jax.random.PRNGKey(clip)
        jstate, jout = jupdate(
            cfg, jstate, jnp.asarray(x), jnp.asarray(sx), jnp.int32(n_new),
            key)
        tstate, tout = tfm.flash_stream_update(
            cfg, tstate, _t(x), _t(sx), n_new, _uniform(key, K + T_new))
        for name in tfm.FlashState._fields:
            got, want = getattr(tstate, name), getattr(jstate, name)
            got = got if name == "n_frames" else got.numpy()
            np.testing.assert_allclose(got, np.asarray(want), atol=STATE_ATOL,
                                       err_msg=f"clip {clip} state.{name}")
        for name in tfm.FlashMemoryOutput._fields:
            np.testing.assert_allclose(
                getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                atol=STATE_ATOL, err_msg=f"clip {clip} out.{name}")
    assert tstate.n_frames == 17 > bank         # the ring wrapped
    assert bool(tstate.tem_valid.all())


def test_snapshot_tensors_are_fresh():
    """A published snapshot never aliases the in-place banks."""
    cfg = FlashMemoryConfig(temporal_length=8, spatial_length=4)
    state = tfm.init_flash_state(cfg, 16, 4, 8, bank_size=8)
    x, sx = torch.ones(2, 16, 8), torch.ones(2, 4, 8)
    state, out = tfm.flash_stream_update(cfg, state, x, sx, 2,
                                         torch.rand(cfg.csm_grid_len + 2))
    before = [t.clone() for t in out]
    for _ in range(5):
        state, _ = tfm.flash_stream_update(cfg, state, x * 3, sx * 3, 2,
                                           torch.rand(cfg.csm_grid_len + 2))
    for a, b in zip(out, before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method", ["sample", "merge", "drop", "attention"])
def test_unported_temporal_methods_raise(method):
    cfg = FlashMemoryConfig(temporal_method=method)
    state = tfm.init_flash_state(cfg, 4, 1, 2, bank_size=4)
    with pytest.raises(NotImplementedError, match="A14"):
        tfm.flash_stream_update(cfg, state, torch.zeros(1, 4, 2),
                                torch.zeros(1, 1, 2), 1, torch.rand(61))
