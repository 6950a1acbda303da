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


# --- the card dry run's limit (DRY_RUN_LIMIT) -------------------------------

@pytest.fixture(scope="module")
def dry_case(tmp_path_factory):
    return cs.dry_run_case(str(tmp_path_factory.mktemp("dry_run")))


def _moved(errs, ref):
    return {n: e for n, e in errs.items() if ref[n].norm() > 0}


def test_dry_run_limit_lies_above_cpu_thread_noise(dry_case):
    """The dry run's bf16 updates at 1 thread and at the default threads
    (summation order) differ by less than the limit; the losses by less
    than 1e-2."""
    n = torch.get_num_threads()
    l_a, d_a = cs.dry_run_updates(dry_case, CPU, torch.bfloat16, "a")
    torch.set_num_threads(1)
    try:
        l_b, d_b = cs.dry_run_updates(dry_case, CPU, torch.bfloat16, "b")
    finally:
        torch.set_num_threads(n)
    errs = _moved(cs.leaf_errors(d_b, d_a), d_a)
    _show("dry run, bf16 at 1 thread vs default", errs)
    assert errs and max(errs.values()) < cs.DRY_RUN_LIMIT
    assert max(abs(a - b) / abs(b) for a, b in zip(l_b, l_a)) < 1e-2


def test_dry_run_limit_lies_below_a_planted_dk_fault(dry_case, monkeypatch):
    """dk scaled by 0.9 in the attention backward moves the worst adapter
    leaf's update past the limit (the bf16 base against the f32 one is
    printed beside it: the reason the card is held to the CPU's bf16 run,
    not to the f32 dry run)."""
    _, good = cs.dry_run_updates(dry_case, CPU, torch.bfloat16, "good")
    _, f32 = cs.dry_run_updates(dry_case, CPU, torch.float32, "f32")
    _show("dry run, bf16 vs f32 base", _moved(cs.leaf_errors(good, f32), f32))
    plain = fa.flash_attention_bwd_reference

    def faulty(*args, **kw):
        dq, dk, dv = plain(*args, **kw)
        return dq, dk * 0.9, dv

    monkeypatch.setattr(fa, "flash_attention_bwd_reference", faulty)
    _, bad = cs.dry_run_updates(dry_case, CPU, torch.bfloat16, "bad")
    errs = _moved(cs.leaf_errors(bad, good), good)
    _show("dry run, dk x 0.9 vs the plain backward", errs)
    assert max(errs.values()) > cs.DRY_RUN_LIMIT


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (sm_90a)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_dry_run_on_card_holds_to_the_cpu_run(cuda, tmp_path):
    """`finetune_flash --dry-run --max-steps 2` on the card (chip_smoke's
    dry_run_train phase): the entry point exits 0 with no --device, K3, K4
    and K5 launch at the tiny head dims, and the adapters' updates hold to
    the CPU run within DRY_RUN_LIMIT."""
    k = cs.run_dry_run_train(cuda, str(tmp_path))
    assert k["K3"] and k["K4"] and k["K5"]
