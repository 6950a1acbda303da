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
import ctypes

import numpy as np
import pytest
import torch

from flash_vstream_tpu_torch.kernels import flash_attention as fa
from flash_vstream_tpu_torch.scripts import probe_flash_bwd

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
    # the training's group size: 7 q heads a kv head
    "gqa7_causal_segments_d64": (1, 7, 1, 70, 70, 64, True, True),
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
# K4/K5's launch plan and probe
# ---------------------------------------------------------------------------

def _blocks(kernel, plan, B, Hq, S):
    """(batch, head, tile) of each block in launch order, as the C kernels
    map blockIdx (x: tiles x Hq, heads fastest; y: batch): K4 walks its q
    tiles from the last, K5 its kv tiles from the first."""
    n = -(-S // plan.rows_per_block)
    out = []
    for b in range(B):
        for x in range(n * Hq):
            t = x // Hq
            out.append((b, x % Hq, n - 1 - t if kernel == "dq" else t))
    return out


def _causal_work(kernel, tile, rows, Sq, Skv):
    """64-row tiles a causal block walks: K4's kv tiles up to its last q
    row, K5's q tiles from its first kv row's tile to the end."""
    if kernel == "dq":
        return -(-min((tile + 1) * rows, Sq, Skv) // fa.BLOCK_N)
    return -(-Sq // fa.BLOCK_N) - (tile * rows) // fa.BLOCK_N


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 63, 64, 65, 333, 700, 4096])
@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("g", [1, 2, 7])
def test_bwd_launch_plan_covers_every_tile_once(kernel, S, D, g):
    """K4's plan covers every (batch, q head, q tile) and K5's every
    (batch, q head, kv tile) exactly once, heaviest first under causality;
    rows per block one the C entries take, tiles covering S; shared bytes
    within the 227 KB opt-in; K5's scratch [2, B, Hq, Skv, D] f32 only for
    a group of more than one q head."""
    for B, Hkv in ((1, 4), (2, 1)):
        Hq = g * Hkv
        plan = fa._bwd_launch_plan(kernel, B, Hq, Hkv, S, S, D)
        rows = plan.rows_per_block
        assert rows in fa.BWD_ROWS_PER_BLOCK
        n = -(-S // rows)
        assert (n - 1) * rows < S <= n * rows
        blocks = _blocks(kernel, plan, B, Hq, S)
        assert len(blocks) == plan.blocks == len(set(blocks))
        assert set(blocks) == {(b, h, t) for b in range(B)
                               for h in range(Hq) for t in range(n)}
        work = [_causal_work(kernel, t, rows, S, S) for _, _, t in blocks]
        for b in range(B):
            w = work[b * n * Hq:(b + 1) * n * Hq]
            assert w == sorted(w, reverse=True)
        assert plan.smem_bytes == fa._bwd_smem_bytes(kernel, rows, D)
        assert plan.smem_bytes <= 232_448
        want = (2, B, Hq, S, D) if kernel == "dkv" and g > 1 else None
        assert plan.scratch == want


@pytest.mark.parametrize("kernel, B, Hq, Hkv, S, rows", [
    ("dq", 1, 28, 4, 4096, 64), ("dkv", 1, 28, 4, 4096, 64),
    ("dq", 1, 28, 4, 8192, 64), ("dkv", 1, 28, 4, 8193, 128),
    ("dq", 1, 28, 4, 14000, 128), ("dkv", 1, 28, 4, 14000, 128),
    ("dq", 1, 28, 4, 64, 64), ("dkv", 1, 1, 1, 14000, 64),
    ("dq", 1, 1, 1, 4096, 64), ("dkv", 2, 6, 2, 301, 64)])
def test_bwd_launch_plan_rows(kernel, B, Hq, Hkv, S, rows):
    """64 rows a block (the training shape), 128 above BWD_WIDE_MIN_S (the
    production length) unless 128-row blocks would leave SMs idle."""
    assert fa._bwd_launch_plan(kernel, B, Hq, Hkv, S, S,
                               128).rows_per_block == rows


def test_bwd_launch_plan_takes_a_forced_rows_per_block():
    for kernel in ("dq", "dkv"):
        for rows in fa.BWD_ROWS_PER_BLOCK:
            plan = fa._bwd_launch_plan(kernel, 1, 28, 4, 4096, 4096, 128,
                                       rows)
            assert plan.rows_per_block == rows
            assert plan.blocks == 28 * -(-4096 // rows)
        with pytest.raises(ValueError, match="rows_per_block"):
            fa._bwd_launch_plan(kernel, 1, 28, 4, 4096, 4096, 128, 32)
        with pytest.raises(ValueError, match="head_dim"):
            fa._bwd_launch_plan(kernel, 1, 28, 4, 4096, 4096, 96)
    with pytest.raises(ValueError, match="kernel"):
        fa._bwd_launch_plan("dk", 1, 28, 4, 4096, 4096, 128)
    # K4's bytes do not depend on its rows; K5's hold its K and V rows
    assert fa._bwd_smem_bytes("dq", 64, 128) == fa._bwd_smem_bytes(
        "dq", 128, 128)
    assert (fa._bwd_smem_bytes("dkv", 128, 128)
            - fa._bwd_smem_bytes("dkv", 64, 128)) == 2 * 64 * 136 * 2


@pytest.mark.parametrize("variant", sorted(probe_flash_bwd.PATCHES))
def test_probe_bwd_variants_patch_the_kernel_source(tmp_path, variant):
    """Every edit of the K4/K5 probe (ablations, planted faults) applies
    exactly once to the kernel source as it is."""
    d = probe_flash_bwd.make_variant(variant, tmp_path)
    cu = (d / "flash_vstream_tpu_torch/kernels/csrc/flash_attention_bwd.cu"
          ).read_text()
    base = (probe_flash_bwd.PKG / probe_flash_bwd.SRC).read_text()
    assert (cu == base) == (variant == "base")
    assert (d / "chip_smoke.py").exists()


@pytest.mark.parametrize("message, caught", [
    ("AssertionError: backward train: out 7.812e-03 lse 1.907e-06 grads/max "
     "dq=4.120e-03 dk=3.900e-03 dv=4.000e-03 by row dq=1.300e-01 "
     "dk=7.800e-03 dv=7.700e-03", True),
    ("AssertionError: backward train: out 7.812e-03 lse 1.907e-06 grads/max "
     "dq=4.120e-02 dk=3.900e-03 dv=4.000e-03 by row dq=1.300e-01 "
     "dk=7.800e-03 dv=7.700e-03", False),
    ("AssertionError: backward train: out 7.812e-03 lse 1.907e-06 grads/max "
     "dq=4.120e-03 dk=3.900e-03 dv=4.000e-03 by row dq=1.000e-02 "
     "dk=7.800e-03 dv=7.700e-03", False),
    ("AssertionError: backward train: a masked query row is not exactly 0",
     False)])
def test_probe_bwd_counts_a_fault_caught_by_the_row_limit_alone(message,
                                                                caught):
    """A planted fault counts only if the 2e-2-of-max bound would pass it."""
    assert probe_flash_bwd.caught_by_row(message) is caught


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_case(dev, name):
    """A CASES or TILE_CASES entry as bf16 card tensors (q, k, v, do) and
    keywords."""
    tb = lambda x: torch.from_numpy(x).to(dev, torch.bfloat16)
    if name in fa.TILE_CASES:
        B, Hq, Hkv, Sq, Skv, D, causal, q_runs, kv_runs = fa.TILE_CASES[name]
        q, k, v, do, _, _ = _inputs(5, B, Hq, Hkv, Sq, Skv, D, False)
        return tuple(map(tb, (q, k, v, do))), dict(
            causal=causal, q_segment_ids=fa.segment_ids(q_runs, B, Sq, dev),
            kv_segment_ids=fa.segment_ids(kv_runs, B, Skv, dev))
    B, Hq, Hkv, Sq, Skv, D, causal, seg = CASES[name]
    q, k, v, do, qs, ks = _inputs(4, B, Hq, Hkv, Sq, Skv, D, seg)
    ti = lambda x: None if x is None else torch.from_numpy(x).to(dev)
    return tuple(map(tb, (q, k, v, do))), dict(
        causal=causal, q_segment_ids=ti(qs), kv_segment_ids=ti(ks))


def _assert_grads_close(q, k, v, out, do, lse, grads, kw):
    """K4/K5's dq, dk, dv against their plain version on their own inputs
    (K3's out and lse): 2e-2 x max |plain| over the tensor and, row by row,
    2e-2 x the row's max |plain|, so the large gradients of a causal run's
    first rows cannot hide the rest (a query that sees one key has a
    gradient of 0 up to rounding and is held by the first bound); dq of a
    query that sees no key and dk/dv of a key no query sees exactly 0."""
    p_grads = fa.flash_attention_bwd_reference(q, k, v, out, do, lse, **kw)
    vis = fa._visible(q, k, kw["causal"], kw["q_segment_ids"],
                      kw["kv_segment_ids"])[:, 0, 0]
    q_rows = (vis.sum(-1) >= 2)[:, None].expand(-1, q.shape[1], -1)
    k_rows = vis.any(1)[:, None].expand(-1, k.shape[1], -1)
    for got, want, rows in zip(grads, p_grads, (q_rows, k_rows, k_rows)):
        assert torch.isfinite(got).all()
        err = (got.float() - want.float()).abs()
        assert err.max() <= 2e-2 * want.float().abs().max()
        row_scale = want.float().abs().amax(-1).clamp_min(1e-30)
        assert (err.amax(-1) / row_scale)[rows].max() <= 2e-2
    dq, dk, dv = grads
    dead_q = ~vis.any(-1)[:, None].expand(-1, q.shape[1], -1)
    unseen = ~vis.any(1)[:, None].expand(-1, k.shape[1], -1)
    assert not dq[dead_q].any()
    assert not dk[unseen].any() and not dv[unseen].any()


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernels_match_plain_on_card(cuda, name):
    (q, k, v, do), kw = _card_case(cuda, name)
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
    _assert_grads_close(q, k, v, out.detach(), do, lse, (dq, dk, dv), kw)
    if kw["q_segment_ids"] is not None:
        assert torch.equal(dq[:, :, -3:], torch.zeros_like(dq[:, :, -3:]))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(fa.TILE_CASES))
def test_tile_cases_through_backward_kernels_on_card(cuda, name):
    """K4 and K5 at the tile cases, which give each kernel every kind of
    (warp, tile): skip, full and masked."""
    (q, k, v, do), kw = _card_case(cuda, name)
    out, lse = fa.flash_attention_fwd_lse_cuda(q, k, v, **kw)
    grads = fa.flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    _assert_grads_close(q, k, v, out, do, lse, grads, kw)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES) + sorted(fa.TILE_CASES))
def test_backward_bit_identical_across_runs_and_rows_per_block(cuda, name):
    """dq, delta, dk and dv: the same bits in a second run and at every
    rows per block the C entries take (no atomics, fixed-order sums)."""
    (q, k, v, do), kw = _card_case(cuda, name)
    out, lse = fa.flash_attention_fwd_lse_cuda(q, k, v, **kw)
    dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, out, do, lse, **kw)
    dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, out, do, lse, delta,
                                             **kw)
    args = (kw["causal"], kw["q_segment_ids"], kw["kv_segment_ids"], None)
    for rows in (None, *fa.BWD_ROWS_PER_BLOCK):
        got = (torch.empty_like(q), torch.empty_like(delta),
               torch.empty_like(k), torch.empty_like(v))
        fa._launch_bwd("dq", q, k, v, out, do, lse, got[1], got[0], None,
                       None, *args, rows_per_block=rows)
        fa._launch_bwd("dkv", q, k, v, out, do, lse, got[1], None, got[2],
                       got[3], *args, rows_per_block=rows)
        torch.cuda.synchronize()
        for a, b in zip(got, (dq, delta, dk, dv)):
            assert torch.equal(a, b), rows


@pytest.mark.gpu
def test_bwd_c_entries_refuse_a_plan_they_do_not_take(cuda):
    """Rows per block outside {64, 128}, shared bytes other than the
    kernel's own, or (K5) a group of q heads without scratch, or scratch
    without one, are refused before launch."""
    from flash_vstream_tpu_torch.kernels import _build
    lib = _build.library()
    q = torch.zeros(1, 2, 64, 64, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 64, device=cuda)
    buf = torch.zeros(2, 1, 2, 64, 64, device=cuda)
    strides = (ctypes.c_longlong * 24)(*(list(q.stride()[:3]) * 8))
    for kernel, hkv, rows, smem, scratch in (
            ("dq", 2, 32, fa._bwd_smem_bytes("dq", 64, 64), None),
            ("dq", 2, 64, fa._bwd_smem_bytes("dq", 64, 64) + 16, None),
            ("dkv", 2, 96, fa._bwd_smem_bytes("dkv", 64, 64), None),
            ("dkv", 2, 128, fa._bwd_smem_bytes("dkv", 64, 64), None),
            ("dkv", 1, 64, fa._bwd_smem_bytes("dkv", 64, 64), None),
            ("dkv", 2, 64, fa._bwd_smem_bytes("dkv", 64, 64), buf)):
        p = q.data_ptr()
        rc = getattr(lib, f"fvt_flash_attention_bwd_{kernel}")(
            p, p, p, p, p, lse.data_ptr(), lse.data_ptr(), p, p, p, None,
            None, None if scratch is None else scratch.data_ptr(), strides,
            1, 2, 64, 64, hkv, 64, 0, rows, smem, 0.125,
            torch.cuda.current_stream(cuda).cuda_stream)
        assert rc != 0, (kernel, hkv, rows, smem)


@pytest.mark.gpu
def test_function_raises_instead_of_falling_back(cuda):
    x = torch.zeros(1, 2, 8, 128, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(x, x, x)                    # f32 on the card
    y = torch.zeros(1, 2, 8, 96, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(y, y, y)


# --- head dims below 64: K3 and K4/K5 zero-pad them as K1 does -------------

# the tiny dry-run config's head dims (LLM 16, ViT 8), with GQA, causal
# masks and segments
SMALL_D_CASES = {
    "d8_causal_gqa_segments": (2, 4, 2, 23, 23, 8, True, True),
    "d16_causal_gqa": (1, 4, 2, 40, 40, 16, True, False),
    "d16_segments_ragged": (1, 2, 1, 19, 27, 16, False, True),
}


def _small_case(name, seed=6):
    B, Hq, Hkv, Sq, Skv, D, causal, seg = SMALL_D_CASES[name]
    q, k, v, do, qs, ks = _inputs(seed, B, Hq, Hkv, Sq, Skv, D, seg)
    return (tuple(map(_t, (q, k, v, do))),
            dict(causal=causal, q_segment_ids=_t(qs), kv_segment_ids=_t(ks)))


@pytest.mark.parametrize("name", sorted(SMALL_D_CASES))
def test_padded_plain_equals_unpadded_plain(name):
    """`fwd_padded`/`bwd_padded`, the wrappers' padding, around the plain
    versions (f32): the output, lse, dq, dk and dv equal the unpadded plain
    versions' up to f32 summation order (1e-6 of each tensor's max)."""
    (q, k, v, do), kw = _small_case(name)
    want_o, want_lse = fa.flash_attention_fwd_lse_reference(q, k, v, **kw)
    got_o, got_lse = fa.fwd_padded(fa.flash_attention_fwd_lse_reference,
                                   q, k, v, **kw)
    assert got_o.shape == want_o.shape and got_lse.shape == want_lse.shape
    tol = lambda w: 1e-6 * max(w.abs().max().item(), 1e-30)   # noqa: E731
    assert (got_o - want_o).abs().max().item() <= tol(want_o)
    live = torch.isfinite(want_lse)
    assert torch.equal(live, torch.isfinite(got_lse))
    assert (got_lse[live] - want_lse[live]).abs().max().item() <= tol(
        want_lse[live])
    want = fa.flash_attention_bwd_reference(q, k, v, want_o, do, want_lse,
                                            **kw)
    got = fa.bwd_padded(fa.flash_attention_bwd_reference, q, k, v, want_o,
                        do, want_lse, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() <= tol(w)


@pytest.mark.parametrize("name", sorted(SMALL_D_CASES))
def test_padded_columns_get_exactly_zero_gradients(name):
    """The plain backward on the padded operands writes exact zeros in the
    columns the padding added, so slicing them off loses nothing, and the
    padded forward's extra output columns are exactly zero."""
    (q, k, v, do), kw = _small_case(name)
    D = q.shape[-1]
    pq, pk, pv, pdo = fa._pad_head_dim(q, k, v, do)
    scale = 1.0 / np.sqrt(D)
    out, lse = fa.flash_attention_fwd_lse_reference(pq, pk, pv, scale=scale,
                                                    **kw)
    assert out.shape[-1] == fa.HEAD_DIMS[0]
    assert not out[..., D:].any()
    for g in fa.flash_attention_bwd_reference(pq, pk, pv, out, pdo, lse,
                                              scale=scale, **kw):
        assert not g[..., D:].any()
        assert g[..., :D].any()


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SMALL_D_CASES))
def test_padded_kernels_match_plain_on_card(cuda, name):
    """K3 and K4/K5 at head dims 8 and 16 (zero-padded to 64 by their
    wrappers) within the card checks' limits: the output within 2e-2, the
    gradients within 2e-2 of the tensor's and of each row's max."""
    (q, k, v, do), kw = _small_case(name)
    q, k, v, do = (x.to(cuda, torch.bfloat16) for x in (q, k, v, do))
    kw = {n: x.to(cuda) if torch.is_tensor(x) else x for n, x in kw.items()}
    n = [f.launches for f in (fa.flash_attention_fwd_lse_cuda,
                              fa.flash_attention_bwd_dq_cuda,
                              fa.flash_attention_bwd_dkv_cuda)]
    out, lse = fa.flash_attention_fwd_lse_cuda(q, k, v, **kw)
    grads = fa.flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    assert [f.launches for f in (fa.flash_attention_fwd_lse_cuda,
                                 fa.flash_attention_bwd_dq_cuda,
                                 fa.flash_attention_bwd_dkv_cuda)] == [
        c + 1 for c in n]
    assert out.shape == q.shape and all(
        g.shape == x.shape for g, x in zip(grads, (q, k, v)))
    p_out, p_lse = fa.flash_attention_fwd_lse_reference(q, k, v, **kw)
    assert (out.float() - p_out.float()).abs().max().item() <= 2e-2
    live = torch.isfinite(p_lse)
    assert (lse[live] - p_lse[live]).abs().max().item() <= 2e-2
    _assert_grads_close(q, k, v, out, do, lse, grads, kw)


def _llava_train_padding(B, S, pre, post, dev):
    """The LLaVA collator's segment ids of a [B, S] training batch: -1 on a
    left run of the pre segment (left-padded) and on a right run of the
    post segment (right-padded), a different length in each row."""
    seg = torch.zeros(B, S, dtype=torch.int32, device=dev)
    for b in range(B):
        seg[b, :(7 * b) % pre] = -1
        seg[b, S - (11 * b + 5) % post:] = -1
    return seg


@pytest.mark.gpu
@pytest.mark.parametrize("B", [16, 32])
def test_llava_train_shapes_on_card(cuda, B):
    """K3, K4 and K5 through FlashAttentionFunction at the LLaVA training
    stages' attention shapes (Vicuna's 32 heads of 128, S 937 = 64 + 681 +
    192; micro-batch 16 for the finetune, 32 for the pretrain), causal with
    the collator's padding: out within 2e-2 of the plain version, the
    gradients by `_assert_grads_close`, one launch of each kernel."""
    g = torch.Generator(device=cuda).manual_seed(B)
    q, k, v, do = (torch.randn(B, 32, 937, 128, generator=g, device=cuda)
                   .to(torch.bfloat16) for _ in range(4))
    seg = _llava_train_padding(B, 937, 64, 192, cuda)
    kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    fns = (fa.flash_attention_fwd_lse_cuda, fa.flash_attention_bwd_dq_cuda,
           fa.flash_attention_bwd_dkv_cuda)
    n = [f.launches for f in fns]
    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*xs, **kw)
    grads = torch.autograd.grad(out, xs, do)
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [c + 1 for c in n]
    p_out, _ = fa.flash_attention_fwd_lse_reference(q, k, v, **kw)
    assert (out.float() - p_out.float()).abs().max().item() <= 2e-2
    del p_out
    _, lse = fa.flash_attention_fwd_lse_cuda(q, k, v, **kw)
    _assert_grads_close(q, k, v, out.detach(), do, lse, grads, kw)


@pytest.mark.gpu
def test_llava_train_clip_shape_on_card(cuda):
    """K1 at the raw-frame step's CLIP shape (8 videos x 50 frames of 257
    tokens, 16 heads of 64, no mask) within 2e-2 of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(400, 16, 257, 64, generator=g, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    n = fa.flash_attention_cuda.launches
    out = fa.flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == n + 1
    want = fa.flash_attention_reference(q, k, v)
    assert (out.float() - want.float()).abs().max().item() <= 2e-2
