"""The chunked SwiGLU MLP: `swiglu_mlp(params, x, seq_chunk)` and
`decoder_forward(..., mlp_seq_chunk=)` (flash_vstream_tpu_torch/models/
layers.py, llm.py) against JAX's (flash_vstream_tpu/models/layers.py
:444-462, llm.py:94-142) in f32 on the CPU: the output within 1e-5
relative and 1e-6 absolute, the gradients of the input and of every MLP
weight within 1e-5 of each tensor's max (the same f32 arithmetic in
another order; a weight's gradient sums over every token, so its small
entries cancel). The chunk is the largest divisor of S at most
`seq_chunk`; an S with no divisor above 1 (13) runs unchunked. The split path (`TPShard` gate/up/down) runs chunked too."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_vstream_tpu.core.config import LLMConfig
from flash_vstream_tpu.models import layers as jlayers
from flash_vstream_tpu.models.llm import decoder_forward as jdecoder
from flash_vstream_tpu.models.llm import init_llm_params
from flash_vstream_tpu_torch.core.config import LLMConfig as TLLMConfig
from flash_vstream_tpu_torch.models import layers as tlayers
from flash_vstream_tpu_torch.models.llm import decoder_forward
from flash_vstream_tpu_torch.parallel.collectives import single_group
from flash_vstream_tpu_torch.parallel.tensor import TPShard
from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy

CFG_KW = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
              num_layers=2, num_heads=4, num_kv_heads=2)
TOL = dict(rtol=1e-5, atol=1e-6)


def _close(got, want, err_msg=""):
    """A gradient within 1e-5 of the tensor's max |want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max(),
                               err_msg=err_msg)


# (S, seq_chunk): chunks of 4 and 6, S 13 (prime) and a chunk above S
# unchunked, seq_chunk 0 off
CASES = [(12, 5), (12, 7), (13, 4), (12, 16), (12, 0)]


def _mlp(seed=0):
    rng = np.random.default_rng(seed)
    w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(
        np.float32)
    return {"gate": {"w": w(32, 48)}, "up": {"w": w(32, 48)},
            "down": {"w": w(48, 32)}}


def _x(S, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (2, S, 32)).astype(np.float32)


def _jax_mlp(p, x, chunk):
    def f(p, x):
        y = jlayers.swiglu_mlp(p, x, seq_chunk=chunk)
        return jnp.sum(y * jnp.cos(y)), y
    (_, y), g = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    return np.asarray(y), jax.tree.map(np.asarray, g)


def _torch_mlp(p, x, chunk, wrap=lambda t: t):
    leaves = {k: torch.from_numpy(v["w"]).requires_grad_()
              for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y = tlayers.swiglu_mlp({k: {"w": wrap(t)} for k, t in leaves.items()},
                           xt, seq_chunk=chunk)
    (y * torch.cos(y)).sum().backward()
    return (y.detach().numpy(), xt.grad.numpy(),
            {k: t.grad.numpy() for k, t in leaves.items()})


@pytest.mark.parametrize("S,chunk", CASES)
def test_swiglu_seq_chunk_matches_jax(S, chunk):
    p, x = _mlp(), _x(S)
    y, (gp, gx) = _jax_mlp(p, x, chunk)
    ty, tgx, tgp = _torch_mlp(p, x, chunk)
    np.testing.assert_allclose(ty, y, **TOL)
    _close(tgx, gx)
    for k in p:
        _close(tgp[k], gp[k]["w"], err_msg=k)


def test_chunks_checkpointed():
    """Each chunk runs under a checkpoint: the backward recomputes the
    chunk's forward, so the gate product runs S / chunk more times."""
    calls = []
    real = tlayers.dense

    def counted(x, w, b=None):
        calls.append(x.shape[1])
        return real(x, w, b)
    p, x = _mlp(), _x(12)
    tlayers.dense = counted
    try:
        _torch_mlp(p, x, 5)
    finally:
        tlayers.dense = real
    assert calls == [4] * 9 + [4] * 9, calls    # 3 chunks x 3, then again


@pytest.mark.parametrize("S,chunk", [(12, 5), (13, 4)])
def test_split_mlp_chunked(S, chunk):
    """gate/up/down as `TPShard`s of a one-rank group take the split path
    (one column region, a row product), chunked, with JAX's numbers."""
    p, x = _mlp(), _x(S)
    y, (gp, gx) = _jax_mlp(p, x, chunk)
    kinds = {"gate": (1, "column"), "up": (1, "column"), "down": (0, "row")}
    shards = []

    def wrap(t):
        name = ("gate", "up", "down")[len(shards)]
        d, kind = kinds[name]
        shards.append(TPShard(t, d, single_group(), t.shape, kind))
        return shards[-1]
    ty, tgx, tgp = _torch_mlp(p, x, chunk, wrap)
    assert len(shards) == 3
    np.testing.assert_allclose(ty, y, **TOL)
    _close(tgx, gx)
    for k in p:
        _close(tgp[k], gp[k]["w"], err_msg=k)


@pytest.mark.parametrize("S,chunk", [(12, 5), (13, 4)])
@pytest.mark.parametrize("remat", [False, True])
def test_decoder_mlp_seq_chunk_matches_jax(S, chunk, remat):
    """`decoder_forward(mlp_seq_chunk=)` against JAX's no-cache path: the
    hidden states and the gradients of the input embeddings and of the
    stacked MLP weights."""
    cfg = LLMConfig(**CFG_KW)
    params = jax.tree.map(np.asarray,
                          init_llm_params(jax.random.PRNGKey(0), cfg))
    x = _x(S, seed=3)
    pos = np.broadcast_to(np.arange(S)[None], (2, S))
    # a fixed random direction: the final norm makes sum(h * h) constant
    r = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def f(mlp, x):
        p = dict(params, layers=dict(params["layers"], mlp=mlp))
        h, _ = jdecoder(p, cfg, x, jnp.asarray(pos), remat=remat,
                        mlp_seq_chunk=chunk)
        return jnp.sum(h * r), h
    (_, h), (gm, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params["layers"]["mlp"]), jnp.asarray(x))

    tp = params_from_numpy(params, "cpu")
    for v in tp["layers"]["mlp"].values():
        v["w"].requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    th = decoder_forward(tp, TLLMConfig(**CFG_KW), xt,
                         torch.from_numpy(pos.copy()), remat=remat,
                         mlp_seq_chunk=chunk)
    (th * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(h), **TOL)
    _close(xt.grad.numpy(), gx)
    for k, v in tp["layers"]["mlp"].items():
        _close(v["w"].grad.numpy(), gm[k]["w"], err_msg=k)
