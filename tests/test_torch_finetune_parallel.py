"""The training entry points across ranks: `finetune_flash.run_training
--dry-run` with --pp 2, with --sp 2 and with --zero-stage 3
--offload-moments, and the LLaVA `train.run_training --dry-run
--zero-stage 3`, each in two gloo ranks on the CPU (one spawn for the
three Qwen runs, one for LLaVA), against JAX's `run_training` on its
virtual CPU mesh in this process, over the same global batch: JAX's dry
run is data-parallel over its 8 devices at --batch-size 1 (dp 4 beside pp
or sp 2: 4 samples a step; dp 8: 8), the port's ranks take --batch-size 4
each (dp 1 beside pp or sp 2; dp 2 under ZeRO-3).

Qwen: test_torch_train.py's dry run (4 items of 4 frame pairs: no k-means
draws; JAX's base and adapters carried across), 2 steps: losses within
1e-4 relative of JAX's and the final adapters within 1e-4 x max of JAX's
checkpoint in 99% of their elements (as test_torch_train.py), the two
ranks' adapters equal. LLaVA: test_torch_llava_train.py's dry run (16
items of 5 frames, the finetune stage: the history fills the long memory,
so no k-means draws, and a draw would raise), 2 steps of 8 samples:
losses within 1e-4 relative of JAX's at world 1 and at world 2, and every
trained leaf at world 2 within 5e-4 relative and 5e-5 absolute of the
world-1 run's."""
import jax
import numpy as np
import pytest
import torch

import torch_ranks
from flash_vstream_tpu.core.config import tiny_llava_config as jtiny_llava
from flash_vstream_tpu.core.config import tiny_qwen_config as jtiny_qwen
from flash_vstream_tpu.models import vstream_llava as jvl
from flash_vstream_tpu.models import vstream_qwen as jvq
from flash_vstream_tpu.preprocess.tokenizer import ByteTokenizer as JByte
from flash_vstream_tpu.train import finetune_flash as jft
from flash_vstream_tpu.train import lora as jlora
from flash_vstream_tpu.train import train as jtrain
from flash_vstream_tpu.train.checkpoint import restore_checkpoint
from flash_vstream_tpu_torch.core.config import tiny_llava_config
from flash_vstream_tpu_torch.parallel.collectives import spawn
from flash_vstream_tpu_torch.preprocess.tokenizer import ByteTokenizer
from flash_vstream_tpu_torch.train import train as ttrain
from flash_vstream_tpu_torch.train.lora import tree_leaves_with_path
from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy

torch.set_num_threads(1)
RANK, ALPHA = 4, 8.0
FLAGS = {"pp": ["--pp", "2"], "sp": ["--sp", "2"],
         "zero3": ["--zero-stage", "3", "--offload-moments"]}
PRE, POST, BUCKET = 24, 48, 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _qwen_args(out, data_path, video_dir, batch):
    return ["--dry-run", "--output-dir", out, "--data-path", data_path,
            "--video-dir", video_dir, "--max-steps", "2",
            "--grad-accum", "1", "--max-frames", "8", "--frame-bucket", "8",
            "--max-len", "128", "--max-pixels", str(56 * 56),
            "--lora-rank", str(RANK), "--lora-alpha", str(ALPHA),
            "--learning-rate", "5e-3", "--save-steps", "100",
            "--batch-size", str(batch)]


@pytest.fixture(scope="module")
def qwen(tmp_path_factory):
    d = tmp_path_factory.mktemp("ft")
    jparams = jvq.init_qwen_params(jax.random.PRNGKey(0), jtiny_qwen())
    jl = jlora.init_lora_params(jax.random.PRNGKey(1), jparams, rank=RANK,
                                targets=jlora.QWEN_TARGETS)
    data_path, video_dir = jft.build_synthetic_dataset(
        str(d / "data"), n_items=4, n_frames=8)
    runs = [_qwen_args(str(d / f"torch_{k}"), data_path, video_dir, 4)
            + ["--device", "cpu"] + flags for k, flags in FLAGS.items()]
    spawn(torch_ranks.finetune_runs, 2, str(d), runs, _np(jparams), _np(jl),
          init_file=str(d / "init"))
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return d, data_path, video_dir, ranks


@pytest.mark.parametrize("flag", list(FLAGS))
def test_finetune_across_ranks_matches_jax(qwen, flag):
    d, data_path, video_dir, ranks = qwen
    i = list(FLAGS).index(flag)
    jout = str(d / f"jax_{flag}")
    jres = jft.run_training(jft.make_parser().parse_args(
        _qwen_args(jout, data_path, video_dir, 1) + FLAGS[flag]))
    got = ranks[0][i]
    np.testing.assert_allclose(got["losses"], jres["losses"], rtol=1e-4)
    assert ranks[1][i]["losses"] == got["losses"]
    _, payload = restore_checkpoint(jout)
    for p, ab in got["lora"].items():
        for k, x in ab.items():
            want = np.asarray(payload["params"][p][k])
            near = np.abs(x - want) <= 1e-4 * np.abs(want).max()
            assert near.mean() >= 0.99, f"{flag} {p}/{k}: {near.mean()}"
            np.testing.assert_array_equal(ranks[1][i]["lora"][p][k], x)


def _llava_args(out, data_path, feature_dir, batch):
    return ["--dry-run", "--output-dir", out, "--stage", "finetune",
            "--data-path", data_path, "--feature-dir", feature_dir,
            "--max-steps", "2", "--batch-size", str(batch),
            "--frame-bucket", str(BUCKET), "--pre-len", str(PRE),
            "--post-len", str(POST), "--learning-rate", "5e-3",
            "--save-steps", "100", "--zero-stage", "3"]


def test_llava_zero3_across_ranks(tmp_path):
    jparams = jvl.init_llava_params(jax.random.PRNGKey(0), jtiny_llava())
    data_path, feature_dir = jtrain.build_synthetic_dataset(
        str(tmp_path / "data"), JByte(), n_frames=5)
    jres = jtrain.run_training(jtrain.make_parser().parse_args(
        _llava_args(str(tmp_path / "jax"), data_path, feature_dir, 1)))
    B = len(jax.devices())
    one = ttrain.run_training(
        ttrain.make_parser().parse_args(_llava_args(
            str(tmp_path / "one"), data_path, feature_dir, B)
            + ["--device", "cpu"]),
        cfg=tiny_llava_config(), params=params_from_numpy(_np(jparams), "cpu"),
        tokenizer=ByteTokenizer(), draws=torch_ranks.no_draws)
    np.testing.assert_allclose(one["losses"], jres["losses"], rtol=1e-4)
    spawn(torch_ranks.llava_run, 2, str(tmp_path),
          _llava_args(str(tmp_path / "two"), data_path, feature_dir, B // 2)
          + ["--device", "cpu"],
          params_from_numpy(_np(jparams), "cpu"),
          init_file=str(tmp_path / "init"))
    two = torch.load(tmp_path / "rank0.pt", weights_only=False)
    np.testing.assert_allclose(two["losses"], jres["losses"], rtol=1e-4)
    whole = dict(tree_leaves_with_path(one["params"]))
    assert two["params"].keys() == {p for p, x in whole.items()
                                    if isinstance(x, torch.Tensor)}
    for p, x in two["params"].items():
        np.testing.assert_allclose(x, whole[p].detach().numpy(), rtol=5e-4,
                                   atol=5e-5, err_msg=p)
