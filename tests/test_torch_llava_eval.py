"""The LLaVA family's feature-based eval and feature extraction of the port
against JAX's, in f32 on the CPU at the tiny LLaVA config: the eval worker
(eval/model_video_qa.py) over `.safetensors` and `.npy` features (a
sample's system text, resume, a missing feature file resampled) and over
raw frame directories, its answers' ids equal to the JAX worker's on the
same parameters and STAR draws; `eval_any_dataset_features --skip-judge`
in one process (the same predictions as JAX's launcher) and in two worker
subprocesses; `extract_features --dry-run` writing the same features as
the JAX script within the stated tolerance, skipping what exists and
reporting a failed video."""
import json
import os
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from flash_vstream_tpu.core.config import tiny_llava_config
from flash_vstream_tpu.eval import model_video_qa as jqa
from flash_vstream_tpu.models import vstream_llava as jvl
from flash_vstream_tpu.preprocess.tokenizer import ByteTokenizer as JByte
from flash_vstream_tpu.runtime.pipeline import LLaVAPipeline as JPipeline
from flash_vstream_tpu_torch.eval import eval_any_dataset_features as tlaunch
from flash_vstream_tpu_torch.eval import model_video_qa as tqa
from flash_vstream_tpu_torch.preprocess.tokenizer import ByteTokenizer
from flash_vstream_tpu_torch.runtime.pipeline import LLaVAPipeline
from flash_vstream_tpu_torch.scripts import extract_features as textract
from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy
from flash_vstream_tpu_torch.weights.safetensors_io import save_file

torch.set_num_threads(1)
TOKENS = 12


@pytest.fixture(scope="module")
def model():
    cfg = tiny_llava_config()
    jparams = jvl.init_llava_params(jax.random.PRNGKey(0), cfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jparams, tparams


def _record(generator):
    ids, generate = [], generator.generate

    def recorded(*a, **k):
        out = generate(*a, **k)
        ids.append([int(t) for t in out])
        return out
    generator.generate = recorded
    return ids


def _pipelines(model):
    """The JAX and the port's pipelines on one tree; the port's answers
    take JAX's STAR draws (PRNGKey(0) uniforms); both record their ids."""
    cfg, jparams, tparams = model
    jp = JPipeline(jparams, cfg, JByte(), max_len=1024)
    tp = LLaVAPipeline(tparams, cfg, ByteTokenizer(), max_len=1024)
    answer = tp.answer

    def with_jax_draws(frames, q, gen=None, seed=0, features=None,
                       draws=None):
        return answer(frames, q, gen, seed, features, draws or (
            lambda n: torch.from_numpy(np.array(jax.random.uniform(
                jax.random.PRNGKey(seed), (n,))))))
    tp.answer = with_jax_draws
    return jp, tp, _record(jp.generator), _record(tp.generator)


def _feature_set(root, n_videos=3, missing=True):
    """`.safetensors` (f16, the extractor's format) and `.npy` (f32)
    features of videos of 3-5 frames (at most 4 history frames, which the
    tiny config's 4 long-memory slots keep as they are: k-means over
    random features would decide by rounding, and a two-frame cluster
    ties the key-frame retrieval; tests/test_torch_llava_train.py holds
    k-means), and a QA file: a system text on one sample, a missing video
    on another."""
    rng = np.random.default_rng(0)
    fdir = os.path.join(root, "features")
    os.makedirs(fdir, exist_ok=True)
    qa = []
    for i in range(n_videos):
        x = rng.normal(size=(3 + i, 64, 32)).astype(np.float32)
        if i % 2:
            np.save(os.path.join(fdir, f"v{i}.npy"), x)
        else:
            save_file({"feature": torch.from_numpy(x.astype(np.float16))},
                      os.path.join(fdir, f"v{i}.safetensors"))
        qa.append({"id": i, "video_id": f"v{i}",
                   "question": f"What happens in video {i}?",
                   "answer": "something"})
    qa[1]["system"] = "Answer briefly."
    if missing:
        qa.append({"id": 9, "video_id": "gone", "question": "Where?",
                   "answer": "nowhere"})
    gt = os.path.join(root, "test_qa.json")
    with open(gt, "w") as f:
        json.dump(qa, f)
    return fdir, gt


def _worker_args(parser, fdir, gt, out, *extra):
    return parser.parse_args(["--video_dir", fdir, "--gt_file", gt,
                              "--output_dir", out, "--dry-run",
                              "--max-new-tokens", str(TOKENS), *extra])


def _preds(path):
    return [json.loads(s) for s in open(path) if s.strip()]


def test_worker_on_features_matches_jax(tmp_path, model):
    """The worker over features: predictions and the answers' token ids
    equal JAX's (the missing file resampled the same way); a second run
    resumes and answers nothing."""
    fdir, gt = _feature_set(str(tmp_path))
    jp, tp, jids, tids = _pipelines(model)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jfile = jqa.run_inference(_worker_args(jqa.make_parser(), fdir, gt,
                                           jout), pipeline=jp)
    tfile = tqa.run_inference(_worker_args(tqa.make_parser(), fdir, gt,
                                           tout, "--device", "cpu"),
                              pipeline=tp)
    assert _preds(tfile) == _preds(jfile)
    assert tids == jids and len(tids) == 4
    tqa.run_inference(_worker_args(tqa.make_parser(), fdir, gt, tout,
                                   "--device", "cpu"), pipeline=tp)
    assert len(tids) == 4 and len(_preds(tfile)) == 4


def test_worker_on_raw_frames_matches_jax(tmp_path, model):
    """--raw-frames over JPEG frame directories: ids equal JAX's."""
    from PIL import Image
    rng = np.random.default_rng(1)
    vdir = tmp_path / "frames"
    qa = []
    for i in range(2):
        d = vdir / f"v{i}"
        d.mkdir(parents=True)
        for t in range(3 + i):
            Image.fromarray(rng.integers(0, 255, (60, 80, 3), dtype=np.uint8)
                            ).save(d / f"frame_{t:03d}.jpg")
        qa.append({"id": i, "video_id": f"v{i}", "question": "Which?"})
    gt = str(tmp_path / "qa.json")
    json.dump(qa, open(gt, "w"))
    jp, tp, jids, tids = _pipelines(model)
    jfile = jqa.run_inference(_worker_args(
        jqa.make_parser(), str(vdir), gt, str(tmp_path / "j"),
        "--raw-frames"), pipeline=jp)
    tfile = tqa.run_inference(_worker_args(
        tqa.make_parser(), str(vdir), gt, str(tmp_path / "t"),
        "--raw-frames", "--device", "cpu"), pipeline=tp)
    assert tids == jids and len(tids) == 2
    assert _preds(tfile) == _preds(jfile)


def _dataset_root(root):
    data = os.path.join(root, "data")
    fdir, gt = _feature_set(os.path.join(data, "msvd"), n_videos=2,
                            missing=False)
    os.rename(fdir, os.path.join(data, "msvd", "features"))
    return data


def test_launcher_matches_jax(tmp_path, model, monkeypatch):
    """`eval_any_dataset_features --skip-judge` in one process: the same
    predictions as JAX's launcher (both workers on the shared tree and
    draws); with --num-chunks 2 two worker subprocesses on the CPU each
    answer their round-robin half into 2_0.json and 2_1.json."""
    from flash_vstream_tpu.eval import eval_any_dataset_features as jlaunch
    data = _dataset_root(str(tmp_path))
    jp, tp, jids, tids = _pipelines(model)
    monkeypatch.setattr(jqa, "build_pipeline", lambda args: jp)
    monkeypatch.setattr(tqa, "build_pipeline", lambda args: tp)
    common = ["--dataset", "msvd", "--data-root", data, "--dry-run",
              "--skip-judge"]
    jlaunch.main(common + ["--output-dir", str(tmp_path / "jo")])
    tlaunch.main(common + ["--output-dir", str(tmp_path / "to"),
                           "--device", "cpu"])
    assert tids == jids and len(tids) == 2
    assert [p["id"] for p in _preds(str(tmp_path / "to" / "pred.json"))] \
        == [p["id"] for p in _preds(str(tmp_path / "jo" / "pred.json"))]
    out = str(tmp_path / "two")
    tlaunch.main(common + ["--output-dir", out, "--device", "cpu",
                           "--num-chunks", "2"])
    got = {n: [p["id"] for p in _preds(os.path.join(out, n))]
           for n in ("2_0.json", "2_1.json")}
    assert got == {"2_0.json": [0], "2_1.json": [1]}


def test_extract_features_matches_jax(tmp_path, model, capsys):
    """`extract_features --dry-run` over JPEG frame directories (batches of
    4 frames, a 6-frame video) on the JAX tree: f16 features [T, 64, 32]
    within 2e-3 of the max of JAX's script's (f32 math both sides, one f16
    rounding each: read 0 or one f16 step); an existing output is skipped
    and an empty directory reported as failed."""
    from PIL import Image
    cfg, jparams, tparams = model
    rng = np.random.default_rng(2)
    vdir = tmp_path / "videos"
    for i, n in enumerate((6, 3)):
        d = vdir / f"v{i}"
        d.mkdir(parents=True)
        for t in range(n):
            Image.fromarray(rng.integers(0, 255, (50, 70, 3), dtype=np.uint8)
                            ).save(d / f"{t:04d}.jpg")
    (vdir / "empty").mkdir()
    jout, tout = tmp_path / "jf", tmp_path / "tf"
    argv = ["--video_dir", str(vdir), "--dry-run", "--batch-frames", "4"]
    old = sys.argv
    try:
        sys.argv = ["extract_features.py", *argv, "--output_dir", str(jout)]
        runpy.run_path(os.path.join(os.path.dirname(__file__), "..",
                                    "scripts", "extract_features.py"),
                       run_name="__main__")
    finally:
        sys.argv = old
    args = textract.make_parser().parse_args(
        argv + ["--output_dir", str(tout), "--device", "cpu"])
    written = textract.extract(args, cfg, tparams)
    assert written == ["v0", "v1"]
    assert "failed empty" in capsys.readouterr().out
    from safetensors.numpy import load_file
    for vid, n in (("v0", 6), ("v1", 3)):
        want = load_file(str(jout / f"{vid}.safetensors"))["feature"]
        got = load_file(str(tout / f"{vid}.safetensors"))["feature"]
        assert got.shape == want.shape == (n, 64, 32)
        assert got.dtype == np.float16
        err = np.abs(got.astype(np.float32) - want.astype(np.float32)).max()
        assert err <= 2e-3 * np.abs(want.astype(np.float32)).max()
    assert textract.extract(args, cfg, tparams) == []     # all exist
