"""C2: the Pallas forward's arithmetic in torch
(`flash_attention_pallas_emulation`, flash_vstream_tpu_torch/kernels/
flash_attention.py), held to JAX's Pallas kernel run in interpret mode on
the CPU, as tests/test_torch_flash_attention.py runs it, with the kernel's
key tiles set to the emulation's 64.

Inputs are random bf16 q/k/v from a seed (numpy), causal and not, with
segment ids (-1 runs and a row that sees no key), GQA, head dims 64, 80 and
128. Limit: each row within one bf16 step of its own max |Pallas| (the
step of a value of that size: 2**(floor(log2 max) - 7)); the two round p
and the output to bf16 from f32 sums taken in other orders. With f32
inputs (no rounding of p) the emulation is plain attention within 1e-5.
Both bf16 forms, the emulation and `xla_attention`'s (the port's plain
version), sit within two bf16 steps of a row's max from the f32 truth
(read 1.01-1.22 steps: the output's own rounding and p's).

On a card (`gpu`), K1 is held to the emulation by row (`ROW_TOL`) and to
the f32 truth within two bf16 steps of a row's max; chip_smoke.py's `c2`
lines read the three distances at the main path's shapes:
    python -m pytest --noconftest -m gpu tests/test_torch_pallas_emulation.py
"""
import numpy as np
import pytest
import torch

from flash_vstream_tpu_torch.kernels.flash_attention import (
    ROW_TOL, flash_attention_cuda, flash_attention_pallas_emulation,
    flash_attention_reference)

torch.set_num_threads(1)

CASES = {
    # name: (B, Hq, Hkv, Sq, Skv, D, causal, segments)
    "causal_gqa_segments_d128": (1, 8, 2, 256, 256, 128, True, True),
    "noncausal_d80": (2, 4, 4, 200, 200, 80, False, False),
    "causal_d64": (1, 4, 4, 300, 300, 64, True, False),
    "gqa_segments_d80": (1, 6, 2, 150, 230, 80, False, True),
    "causal_segments_d64": (2, 2, 1, 190, 190, 64, True, True),
    "noncausal_gqa_d128": (1, 4, 1, 128, 320, 128, False, False),
}


@pytest.fixture(scope="module")
def jfa():
    pytest.importorskip("jax")
    from flash_vstream_tpu.kernels import flash_attention
    return flash_attention


def _inputs(seed, B, Hq, Hkv, Sq, Skv, D, segments):
    """bf16-exact q/k/v (as f32 numpy) and segment ids: a -1 run inside
    the keys, a -1 tail, and a query whose id no key carries."""
    rng = np.random.default_rng(seed)
    bf = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).bfloat16().float().numpy()
    q, k, v = bf(B, Hq, Sq, D), bf(B, Hkv, Skv, D), bf(B, Hkv, Skv, D)
    qs = ks = None
    if segments:
        ks = np.zeros((B, Skv), np.int32)
        ks[:, Skv // 3:Skv // 3 + 70] = -1
        ks[:, -3:] = -1
        qs = np.zeros((B, Sq), np.int32)
        qs[:, -3:] = -1
        qs[:, 1] = 7
    return q, k, v, qs, ks


def _pad(x, axis, mult, value=0):
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, (-x.shape[axis]) % mult)
    return np.pad(x, widths, constant_values=value)


def _pallas(jfa, q, k, v, qs, ks, causal):
    """The Pallas kernel in interpret mode on bf16 inputs padded as the JAX
    wrapper pads them (S and D to 128; padded keys in segment -1), with
    64-key tiles."""
    from jax.experimental.pallas import tpu as pltpu
    jnp = jfa.jnp
    B, Sq, Skv, D = q.shape[0], q.shape[2], k.shape[2], q.shape[3]
    bf = lambda x: jnp.asarray(_pad(_pad(x, 3, 128), 2, 128),
                               dtype=jnp.bfloat16)
    if qs is None and causal:
        qsp = ksp = None
    else:
        qs = np.zeros((B, Sq), np.int32) if qs is None else qs
        ks = np.zeros((B, Skv), np.int32) if ks is None else ks
        qsp = jnp.asarray(_pad(qs, 1, 128, -1))
        ksp = jnp.asarray(_pad(ks, 1, 128, -1))
    with pltpu.force_tpu_interpret_mode():
        out = jfa._pallas_flash(bf(q), bf(k), bf(v), qsp, ksp, causal=causal,
                                scale=1.0 / np.sqrt(D), block_q=128,
                                block_kv=64)
    return np.asarray(out.astype(jnp.float32))[:, :, :Sq, :D]


def _torch(q, k, v, qs, ks, dtype=torch.bfloat16):
    t = lambda x: torch.from_numpy(x).to(dtype)
    s = lambda x: None if x is None else torch.from_numpy(x)
    return t(q), t(k), t(v), s(qs), s(ks)


def bf16_step(x: torch.Tensor) -> torch.Tensor:
    """The bf16 step of values of |x|'s size: 2**(floor(log2 |x|) - 7)."""
    return torch.exp2(torch.floor(torch.log2(
        x.abs().clamp_min(1e-30))) - 7)


def _row_check(got, want, what, steps=1.0):
    """Each row within `steps` bf16 steps of its own max |want|."""
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    err = (got - want).abs().amax(-1)
    step = bf16_step(want.abs().amax(-1))
    worst = (err / step).max().item()
    assert worst <= steps, f"{what}: {worst:.3f} bf16 steps of a row's max"


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulation_matches_pallas_interpret(jfa, name):
    B, Hq, Hkv, Sq, Skv, D, causal, seg = CASES[name]
    q, k, v, qs, ks = _inputs(0, B, Hq, Hkv, Sq, Skv, D, seg)
    want = _pallas(jfa, q, k, v, qs, ks, causal)
    tq, tk, tv, tqs, tks = _torch(q, k, v, qs, ks)
    got = flash_attention_pallas_emulation(
        tq, tk, tv, causal=causal, q_segment_ids=tqs, kv_segment_ids=tks)
    assert got.dtype == torch.bfloat16
    _row_check(got, want, name)
    if seg:      # the row that sees no key: exactly 0 in both
        assert not got[:, :, 1].any() and not want[:, :, 1].any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulation_in_f32_is_plain_attention(name):
    B, Hq, Hkv, Sq, Skv, D, causal, seg = CASES[name]
    args = _torch(*_inputs(1, B, Hq, Hkv, Sq, Skv, D, seg),
                  dtype=torch.float32)
    kw = dict(causal=causal, q_segment_ids=args[3], kv_segment_ids=args[4])
    got = flash_attention_pallas_emulation(*args[:3], **kw)
    want = flash_attention_reference(*args[:3], **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_forms_near_f32(name):
    """The emulation and the plain bf16 version each within two bf16 steps
    of a row's max from the f32 truth (what chip_smoke.py's c2 lines read on
    the card, there for K1 too)."""
    B, Hq, Hkv, Sq, Skv, D, causal, seg = CASES[name]
    raw = _inputs(2, B, Hq, Hkv, Sq, Skv, D, seg)
    args = _torch(*raw)
    kw = dict(causal=causal, q_segment_ids=args[3], kv_segment_ids=args[4])
    truth = flash_attention_reference(*_torch(*raw, dtype=torch.float32)[:3],
                                      **kw)
    for fn in (flash_attention_pallas_emulation, flash_attention_reference):
        _row_check(fn(*args[:3], **kw), truth, fn.__name__, steps=2.0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_k1_near_emulation_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Hq, Hkv, Sq, Skv, D, causal, seg = CASES[name]
    raw = _inputs(3, B, Hq, Hkv, Sq, Skv, D, seg)
    args = [None if x is None else x.cuda() for x in _torch(*raw)]
    kw = dict(causal=causal, q_segment_ids=args[3], kv_segment_ids=args[4])
    k1 = flash_attention_cuda(*args[:3], **kw)
    emu = flash_attention_pallas_emulation(*args[:3], **kw)
    truth = flash_attention_reference(
        *[x.cuda() for x in _torch(*raw, dtype=torch.float32)[:3]], **kw)
    seen = truth.abs().amax(-1) > 0
    err = ((k1.float() - emu.float()).abs().amax(-1)
           / truth.abs().amax(-1).clamp_min(1e-30))[seen]
    assert err.max() <= ROW_TOL
    _row_check(k1.cpu(), truth.cpu(), f"K1 {name}", steps=2.0)
