"""The LLaVA entry point under tensor parallelism: `train.run_training
--dry-run --tp 2` in two gloo ranks on the CPU (one spawn, both runs)
against the same dry run at world 1 in this process, over the same global
batch (the tp ranks of a dp row read the same samples). The world-1 dry
run is held to JAX's by test_torch_llava_train.py.

Two branches of the finetune stage: precomputed features (the synthetic
feature set, 2 steps of 2 samples) and raw media (`--synthetic-raw`:
frame directories through the frozen CLIP tower, split over tp as
LLM_RULES name it, an image and a text step; 3 steps). Held: the losses
within 1e-5 relative on both ranks, and every leaf of the gathered
parameters within 5e-4 relative and 5e-5 absolute."""
import numpy as np
import pytest
import torch

import torch_ranks
from flash_vstream_tpu_torch.parallel.collectives import spawn
from flash_vstream_tpu_torch.train import train as ttrain
from flash_vstream_tpu_torch.train.lora import tree_leaves_with_path

SMALL = ["--frame-bucket", "8", "--pre-len", "24", "--post-len", "48",
         "--text-len", "64", "--batch-size", "2", "--save-steps", "0",
         "--learning-rate", "5e-3", "--device", "cpu", "--dry-run"]
BRANCHES = {"features": ["--max-steps", "2"],
            "raw": ["--max-steps", "3", "--synthetic-raw"]}


def _argv(out, branch):
    return ["--output-dir", out, *SMALL, *BRANCHES[branch]]


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    d = tmp_path_factory.mktemp("llava_tp")
    spawn(torch_ranks.llava_main, 2, str(d),
          [_argv(str(d / b), b) + ["--tp", "2"] for b in BRANCHES],
          init_file=str(d / "init"))
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


@pytest.mark.parametrize("i,branch", list(enumerate(BRANCHES)))
def test_tp2_dry_run_matches_world_1(tp2, tmp_path, i, branch):
    torch.set_num_threads(1)
    one = ttrain.run_training(ttrain.make_parser().parse_args(
        _argv(str(tmp_path / "one"), branch)))
    if branch == "raw":
        assert set(one["modalities"]) == {"video", "image", "text"}
    whole = {p: x.detach().numpy() for p, x in
             tree_leaves_with_path(one["params"])
             if isinstance(x, torch.Tensor)}
    for r in tp2:
        got = r[i]
        assert got["modalities"] == one["modalities"]
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
        assert got["params"].keys() == whole.keys()
        for p, x in got["params"].items():
            np.testing.assert_allclose(x, whole[p], rtol=5e-4, atol=5e-5,
                                       err_msg=p)
