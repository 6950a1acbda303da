"""The rest of the Flash memory registry against JAX in f32 on the CPU: the
greedy init, PCA and the PCA k-means, DBSCAN and GMM, and
`flash_consolidate` under every temporal method with t below, at and
above csm_grid_len. Tolerance STATE_ATOL (1e-4) on features, weights and
times; labels and positions exact.

PCA's eigenvectors are the solver's: `torch.linalg.eigh` and
`jnp.linalg.eigh` may flip a component's sign, so projected coordinates
are compared up to sign per component, and everything downstream (labels,
weights, original-space centroids) exactly as stated. The port takes
JAX's uniform draws (k-means init, drop coins) through a function n -> [n].
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_vstream_tpu.core.config import FlashMemoryConfig
from flash_vstream_tpu.models import flash_memory as jfm
from flash_vstream_tpu.ops import clustering_extra as jce
from flash_vstream_tpu.ops import kmeans as jk
from flash_vstream_tpu_torch.models import flash_memory as tfm
from flash_vstream_tpu_torch.ops import clustering_extra as tce
from flash_vstream_tpu_torch.ops import kmeans as tk

torch.set_num_threads(1)
STATE_ATOL = 1e-4
METHODS = ("kmeans", "kmeans_ordered", "fast_kmeans_ordered",
           "pca_kmeans_ordered", "torchpca_kmeans_ordered", "merge", "drop",
           "attention", "sample", "dbscan", "gmm")


def _t(x):
    return torch.from_numpy(np.array(x))


def _draws(key):
    return lambda n: _t(jax.random.uniform(key, (n,)))


def _scenes(t, dim, seed=0, n_scenes=3, noise=0.05):
    """t rows of dim features around n_scenes centers, in runs: clusters
    with structure, tight enough for DBSCAN's eps."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_scenes, dim))
    lab = (np.arange(t) * n_scenes) // max(t, 1)
    return (centers[lab] + noise * rng.normal(size=(t, dim))).astype(
        np.float32)


def _close(got, want, msg, atol=STATE_ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               err_msg=msg)


def test_greedy_init_centroids():
    x = _scenes(12, 6, seed=1, noise=0.5)
    valid = np.ones(12, bool)
    valid[[2, 7]] = False
    want = jk.greedy_init_centroids(jnp.asarray(x), 4, jnp.asarray(valid))
    got = tk.greedy_init_centroids(_t(x), 4, _t(valid))
    _close(got, want, "centroids", atol=1e-6)


def test_pca_project_up_to_sign():
    x = np.random.default_rng(2).normal(size=(20, 8)).astype(np.float32)
    want = np.asarray(jk.pca_project(jnp.asarray(x), 3))
    got = tk.pca_project(_t(x), 3).numpy()
    assert got.shape == want.shape == (20, 3)
    signs = np.sign((got * want).sum(0))
    assert (signs != 0).all()
    np.testing.assert_allclose(got * signs, want, atol=1e-4)


def test_pca_weighted_kmeans_ordered():
    x = _scenes(10, 12, seed=3, noise=0.3)           # rows [T, P * D]
    key = jax.random.PRNGKey(4)
    want = jk.pca_weighted_kmeans_ordered(jnp.asarray(x), 4, 2, key=key,
                                          tokens_per_frame=3)
    got = tk.pca_weighted_kmeans_ordered(
        _t(x), 4, 2, init_scores=_draws(key)(10), tokens_per_frame=3)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    for name in ("centroids", "cluster_weights", "timestamps"):
        _close(getattr(got, name), getattr(want, name), name)


def test_dbscan_compress():
    x = _scenes(9, 8, seed=5)
    x[4] += 3.0                                       # a noise point
    valid = np.ones(9, bool)
    valid[7] = False
    for k in (2, 5):                                  # clusters cut, and not
        want = jce.dbscan_compress(jnp.asarray(x), k, valid=jnp.asarray(valid))
        got = tce.dbscan_compress(_t(x), k, valid=_t(valid))
        np.testing.assert_array_equal(got.labels.numpy(),
                                      np.asarray(want.labels))
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        _close(got.centroids, want.centroids, f"k {k}")


def test_gmm_compress():
    x = _scenes(12, 10, seed=6, n_scenes=4, noise=0.3)
    want = jce.gmm_compress(jnp.asarray(x), 4, pca_dim=3,
                            key=jax.random.PRNGKey(0))
    got = tce.gmm_compress(_t(x), 4, pca_dim=3)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    _close(got.centroids, want.centroids, "centroids")


@pytest.mark.parametrize("t", [3, 4, 9])
@pytest.mark.parametrize("method", METHODS)
def test_flash_consolidate_every_method(method, t):
    """CSM and DAM of a whole video: t frames below, at and above the 4 CSM
    slots (DAM 2 slots, retrieved once t > 2)."""
    cfg = dataclasses.replace(
        FlashMemoryConfig(temporal_length=8, spatial_length=4),
        temporal_method=method, temporal_pca_dim=3)
    p_full, p_small, D = 8, 2, 8
    small = _scenes(t, p_small * D, seed=t).reshape(t, p_small, D)
    x = np.random.default_rng(t).normal(size=(t, p_full, D)).astype(
        np.float32)
    key = jax.random.PRNGKey(7)
    want = jfm.flash_consolidate(cfg, jnp.asarray(x), jnp.asarray(small),
                                 key=key)
    got = tfm.flash_consolidate(cfg, _t(x), _t(small), draws=_draws(key))
    for name in ("tem_positions", "spa_positions"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("tem_x", "tem_weights", "spa_x"):
        _close(getattr(got, name), getattr(want, name), name)
