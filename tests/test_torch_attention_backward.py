"""K3, K4, K5 (the flash-attention backward): the port's plain versions
against the Pallas kernels run in interpret mode, `FlashAttentionFunction`
on the CPU against autograd of the plain attention, exact zeros on masked
rows, and the CUDA kernels against the plain versions on a card.

CPU comparisons run in f32 with tolerance 1e-4 x max |JAX| (the same f32
arithmetic summed in another order over up to 256 keys). The card tests run
in bf16: out 2e-2 absolute, gradients 2e-2 x max |plain| over the tensor
and 2e-2 x the row's max |plain| row by row (bf16 outputs of f32 sums). The machine with the card has no JAX, so JAX loads in a fixture;
there the card tests run alone:
    python -m pytest --noconftest -m gpu tests/test_torch_attention_backward.py
"""
import numpy as np
import pytest
import torch

from flash_vstream_tpu_torch.kernels import flash_attention as fa

torch.set_num_threads(1)
REL = 1e-4


@pytest.fixture(scope="module")
def jfa():
    """The JAX kernel module."""
    pytest.importorskip("jax")
    from flash_vstream_tpu.kernels import flash_attention
    return flash_attention


CASES = {
    # name: (B, Hq, Hkv, Sq, Skv, D, causal, segments)
    "causal_gqa_d128": (1, 4, 2, 40, 40, 128, True, False),
    "causal_gqa_segments_d128": (2, 8, 2, 37, 37, 128, True, True),
    "segments_ragged_d80": (1, 6, 3, 21, 29, 80, False, True),
    "segments_d64": (2, 2, 1, 16, 16, 64, False, True),
}


def _inputs(seed, B, Hq, Hkv, Sq, Skv, D, segments):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(B, Hq, Sq, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32)
            for _ in range(2))
    qs = ks = None
    if segments:
        # a -1 run (padded memory slots), a -1 tail, and a q row whose id
        # no key carries (a fully masked row)
        ks = np.zeros((B, Skv), np.int32)
        ks[:, Skv // 3:Skv // 3 + 5] = -1
        ks[:, -3:] = -1
        qs = np.zeros((B, Sq), np.int32)
        qs[:, -3:] = -1
        qs[:, 1] = 7
    return q, k, v, do, qs, ks


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _pad(x, axis, mult, value=0):
    pad = (-x.shape[axis]) % mult
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=value)


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=REL * scale, err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_interpret(jfa, name):
    """`flash_attention_fwd_lse_reference` against `_pallas_flash(save_stats
    =True)` (K3) and `flash_attention_bwd_reference` against
    `_pallas_flash_bwd` (K4, K5), the Pallas kernels run as the JAX tests
    run them on the CPU, with inputs padded as the JAX wrapper pads them (S
    and D to 128, padded segments -1)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    B, Hq, Hkv, Sq, Skv, D, causal, seg = CASES[name]
    q, k, v, do, qs, ks = _inputs(0, B, Hq, Hkv, Sq, Skv, D, seg)
    pq, pk, pv, pdo = (_pad(_pad(x, 3, 128), 2, 128) for x in (q, k, v, do))
    if seg:
        qsp, ksp = _pad(qs, 1, 128, -1), _pad(ks, 1, 128, -1)
    elif not causal:
        qsp = _pad(np.zeros((B, Sq), np.int32), 1, 128, -1)
        ksp = _pad(np.zeros((B, Skv), np.int32), 1, 128, -1)
    else:
        qsp = ksp = None
    j = lambda x: None if x is None else jnp.asarray(x)
    scale = 1.0 / np.sqrt(D)
    with pltpu.force_tpu_interpret_mode():
        jo, jlse = jfa._pallas_flash(j(pq), j(pk), j(pv), j(qsp), j(ksp),
                                     causal=causal, scale=scale,
                                     block_q=128, block_kv=128,
                                     save_stats=True)
        jdq, jdk, jdv = jfa._pallas_flash_bwd(
            j(pq), j(pk), j(pv), jo, j(pdo), jlse, j(qsp), j(ksp),
            causal=causal, scale=scale, block_q=128, block_kv=128)
    jo = np.asarray(jo)[:, :, :Sq, :D]
    jlse = np.asarray(jlse)[:, :, :Sq, 0]
    kw = dict(causal=causal, q_segment_ids=_t(qs), kv_segment_ids=_t(ks))
    out, lse = fa.flash_attention_fwd_lse_reference(_t(q), _t(k), _t(v), **kw)
    _close(out, jo, "out")
    fin = np.isfinite(jlse)
    np.testing.assert_array_equal(np.isfinite(lse.numpy()), fin)
    assert (lse.numpy()[~fin] == -np.inf).all()
    _close(lse[torch.from_numpy(fin)], jlse[fin], "lse")
    dq, dk, dv = fa.flash_attention_bwd_reference(
        _t(q), _t(k), _t(v), out, _t(do), lse, **kw)
    _close(dq, np.asarray(jdq)[:, :, :Sq, :D], "dq")
    _close(dk, np.asarray(jdk)[:, :, :Skv, :D], "dk")
    _close(dv, np.asarray(jdv)[:, :, :Skv, :D], "dv")


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_matches_autograd_of_reference(name):
    """On CPU tensors `flash_attention` with grad runs
    FlashAttentionFunction (plain forward with lse, plain recompute
    backward); its gradients equal autograd of the plain attention."""
    B, Hq, Hkv, Sq, Skv, D, causal, seg = CASES[name]
    q, k, v, do, qs, ks = _inputs(1, B, Hq, Hkv, Sq, Skv, D, seg)
    kw = dict(causal=causal, q_segment_ids=_t(qs), kv_segment_ids=_t(ks))
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_reference):
        xs = [_t(x).requires_grad_() for x in (q, k, v)]
        out = fn(*xs, **kw)
        grads.append((out,) + torch.autograd.grad(out, xs, _t(do)))
    assert grads[0][0].grad_fn.name().startswith("FlashAttentionFunction")
    for got, want, what in zip(grads[0], grads[1], ("out", "dq", "dk", "dv")):
        _close(got, want.detach().numpy(), what)


def test_function_in_bf16_within_the_card_checks_head_limit():
    """chip_smoke.py holds the card's Function to autograd of the plain
    attention within HEAD_L2_LIMIT per head. The Function takes delta from
    its bf16 output and autograd does not; that difference alone, read here
    with the plain versions in bf16 at the check's shape, must lie inside
    the limit (run with -s to print it)."""
    import chip_smoke as cs
    g = torch.Generator().manual_seed(2)
    q, k, v, do = (torch.randn(*s, generator=g).to(torch.bfloat16)
                   for s in ((1, 4, 1000, 128), (1, 2, 1000, 128),
                             (1, 2, 1000, 128), (1, 4, 1000, 128)))
    seg = torch.zeros(1, 1000, dtype=torch.int32)
    seg[:, 950:] = -1
    kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_reference):
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*xs, **kw), xs, do))
    head = [cs.head_l2_err(a, b) for a, b in zip(*grads)]
    print(f"\nbf16 Function vs autograd, rel L2 per head: dq {head[0]:.3e} "
          f"dk {head[1]:.3e} dv {head[2]:.3e}")
    assert max(head) < cs.HEAD_L2_LIMIT


def test_masked_rows_are_exactly_zero():
    """dq of a query that sees no key (an id no key has, the -1 tail) and
    dk/dv of a key no query sees (a -1 key) are exactly 0."""
    q, k, v, do, qs, ks = _inputs(2, 1, 4, 2, 24, 24, 128, True)
    xs = [_t(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*xs, causal=True, q_segment_ids=_t(qs),
                             kv_segment_ids=_t(ks))
    dq, dk, dv = torch.autograd.grad(out, xs, _t(do))
    for x in (out, dq):
        assert torch.equal(x[:, :, 1], torch.zeros_like(x[:, :, 1]))
        assert torch.equal(x[:, :, -3:], torch.zeros_like(x[:, :, -3:]))
    dead = torch.from_numpy(ks[0] < 0)
    for x in (dk, dv):
        assert torch.equal(x[:, :, dead], torch.zeros_like(x[:, :, dead]))
        assert x[:, :, ~dead].abs().max() > 0
    assert all(torch.isfinite(x).all() for x in (out, dq, dk, dv))


def test_no_grad_keeps_the_forward_without_lse():
    """Without grad, flash_attention stays the plain forward (K1's path on
    the card), so serving never pays for the lse."""
    q, k, v, _, qs, ks = _inputs(3, 1, 2, 1, 8, 8, 64, False)
    with torch.no_grad():
        out = fa.flash_attention(*(_t(x).requires_grad_() for x in (q, k, v)),
                                 causal=True)
    assert out.grad_fn is None


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernels_match_plain_on_card(cuda, name):
    B, Hq, Hkv, Sq, Skv, D, causal, seg = CASES[name]
    q, k, v, do, qs, ks = _inputs(4, B, Hq, Hkv, Sq, Skv, D, seg)
    tb = lambda x: torch.from_numpy(x).to(cuda, torch.bfloat16)
    ti = lambda x: None if x is None else torch.from_numpy(x).to(cuda)
    q, k, v, do = map(tb, (q, k, v, do))
    kw = dict(causal=causal, q_segment_ids=ti(qs), kv_segment_ids=ti(ks))
    n = [f.launches for f in (fa.flash_attention_fwd_lse_cuda,
                              fa.flash_attention_bwd_dq_cuda,
                              fa.flash_attention_bwd_dkv_cuda)]
    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*xs, **kw)
    dq, dk, dv = torch.autograd.grad(out, xs, do)
    torch.cuda.synchronize()
    assert [f.launches for f in (fa.flash_attention_fwd_lse_cuda,
                                 fa.flash_attention_bwd_dq_cuda,
                                 fa.flash_attention_bwd_dkv_cuda)] == [
        c + 1 for c in n]
    p_out, _ = fa.flash_attention_fwd_lse_reference(q, k, v, **kw)
    assert (out.float() - p_out.float()).abs().max().item() <= 2e-2
    # K4/K5's plain version on their own inputs: K3's out and lse
    _, lse = fa.flash_attention_fwd_lse_cuda(q, k, v, **kw)
    p_dq, p_dk, p_dv = fa.flash_attention_bwd_reference(q, k, v, out, do,
                                                        lse, **kw)
    # row by row too, each against its own scale, so the large gradients of
    # a causal run's first rows cannot hide the rest; a query that sees one
    # key has a gradient of 0 up to rounding and is held by the first bound
    vis = fa._visible(q, k, causal, kw["q_segment_ids"],
                      kw["kv_segment_ids"])[:, 0, 0]
    q_rows = (vis.sum(-1) >= 2)[:, None].expand(-1, Hq, -1)
    k_rows = vis.any(1)[:, None].expand(-1, Hkv, -1)
    for got, want, rows in ((dq, p_dq, q_rows), (dk, p_dk, k_rows),
                            (dv, p_dv, k_rows)):
        err = (got.float() - want.float()).abs()
        assert err.max() <= 2e-2 * want.float().abs().max()
        row_scale = want.float().abs().amax(-1).clamp_min(1e-30)
        assert (err.amax(-1) / row_scale)[rows].max() <= 2e-2
    if seg:
        assert torch.equal(dq[:, :, -3:], torch.zeros_like(dq[:, :, -3:]))


@pytest.mark.gpu
def test_function_raises_instead_of_falling_back(cuda):
    x = torch.zeros(1, 2, 8, 128, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(x, x, x)                    # f32 on the card
    y = torch.zeros(1, 2, 8, 96, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(y, y, y)
