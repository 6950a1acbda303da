"""Where chip_smoke.py's training-reference limit sits. On the card the
check holds each adapter leaf's bf16 gradient to TRAIN_REF_LIMIT in
relative L2 norm against the CPU's. Here, on the CPU alone, the limit must
lie above what bf16 summation order moves (the same step at 8 threads and at
1 thread) and below what a planted fault moves (dk scaled by 0.9 in the
attention backward). Run with `-s` to print the readings per leaf.
"""
import pytest
import torch

import chip_smoke as cs
from flash_vstream_tpu_torch.kernels import flash_attention as fa

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def case():
    return cs.train_reference_case()


def _grads(case, threads):
    n = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        return cs.lora_leaf_grads(case, CPU, torch.bfloat16)
    finally:
        torch.set_num_threads(n)


def _show(what, errs):
    print(f"\n{what}: " + " ".join(f"{n}={e:.3e}"
                                    for n, e in sorted(errs.items())))


def test_limit_lies_above_bf16_summation_noise(case):
    l8, g8 = _grads(case, 8)
    l1, g1 = _grads(case, 1)
    noise = cs.leaf_errors(g1, g8)
    _show("bf16 at 1 thread vs 8 threads", noise)
    assert abs(l1 - l8) <= 1e-2 * abs(l8)
    assert max(noise.values()) < cs.TRAIN_REF_LIMIT


def test_limit_lies_below_a_planted_dk_fault(case, monkeypatch):
    _, good = _grads(case, 8)
    plain = fa.flash_attention_bwd_reference

    def faulty(*args, **kw):
        dq, dk, dv = plain(*args, **kw)
        return dq, dk * 0.9, dv

    monkeypatch.setattr(fa, "flash_attention_bwd_reference", faulty)
    _, bad = _grads(case, 8)
    errs = cs.leaf_errors(bad, good)
    _show("dk x 0.9 vs the plain backward", errs)
    wk = {n: e for n, e in errs.items() if "/wk/" in n}
    assert wk and min(wk.values()) > cs.TRAIN_REF_LIMIT
