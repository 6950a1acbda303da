"""The port's eval harness (flash_vstream_tpu_torch/eval/) on the CPU: the
Qwen cases of tests/test_eval_harness.py and tests/test_subtitles.py on the
port's modules, the copies of the JAX package's jax-free modules held equal
to their sources, every frame-sampling mode held to JAX's, the worker's
answers held to JAX's worker on the same parameters, `--model-path` on a
checkpoint the port wrote, and one launch of two worker subprocesses.

The worker comparison runs both pipelines' patch streams in f32 (as
tests/test_torch_pipeline.py does for the answers), so every pred must be
JAX's text; its 4 frames make t = 2 frame pairs, under the tiny config's 4
CSM clusters, so no k-means draw enters.
"""
import functools
import glob
import inspect
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from flash_vstream_tpu_torch.eval import eval_any_dataset, gpt_judge
from flash_vstream_tpu_torch.eval import inference_mcq_vqa as worker
from flash_vstream_tpu_torch.eval import subtitles
from flash_vstream_tpu_torch.eval.scoring import (ScoreMeter, calc_mcq_result,
                                                  extract_answer)

torch.set_num_threads(1)
DRY = ["--dry-run", "--max-frames", "4", "--device", "cpu"]


def make_fake_dataset(root, n_videos=2, n_q=4, n_frames=4, npy=False):
    frame_dir = os.path.join(root, "mvbench", "frames")
    rng = np.random.default_rng(0)
    for v in range(n_videos):
        d = os.path.join(frame_dir, f"vid{v}")
        os.makedirs(d, exist_ok=True)
        for i in range(n_frames):
            img = rng.integers(0, 255, size=(56, 56, 3), dtype=np.uint8)
            if npy:
                np.save(os.path.join(d, f"frame_{i:06d}.npy"), img)
            else:
                Image.fromarray(img).save(
                    os.path.join(d, f"frame_{i:06d}.jpg"))
    qa = [{"id": f"{i}", "video_id": f"vid{i % n_videos}",
           "question": f"Q{i}?\nA. one\nB. two\nC. three\nD. four",
           "answer": i % 4, "a_type": "action"} for i in range(n_q)]
    qa_file = os.path.join(root, "mvbench", "test_qa.json")
    with open(qa_file, "w") as f:
        json.dump(qa, f)
    return frame_dir, qa_file


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# the copied modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["scoring", "subtitles", "gpt_judge"])
def test_copies_equal_the_jax_modules(name):
    """Every function, class and constant of the copy has the source of
    the JAX package's module."""
    import importlib
    want = importlib.import_module(f"flash_vstream_tpu.eval.{name}")
    got = importlib.import_module(f"flash_vstream_tpu_torch.eval.{name}")
    names = [n for n, v in vars(want).items()
             if not n.startswith("__") and getattr(v, "__module__", None)
             == want.__name__]
    assert names
    for n in names:
        assert inspect.getsource(getattr(got, n)) == inspect.getsource(
            getattr(want, n)), n
    consts = {n for n, v in vars(want).items()
              if n.isupper() and isinstance(v, (str, tuple, dict, list))}
    for n in consts:
        assert getattr(got, n) == getattr(want, n), n


def test_extract_answer():
    assert extract_answer("B") == 1
    assert extract_answer("The answer is (C).") == 2
    assert extract_answer("A. one") == 0
    assert extract_answer("no letter here!") in range(5)


def test_score_meter():
    m = ScoreMeter()
    m.add_score(1.0, "yes")
    m.add_score(0.0, "no")
    m.add_score(1.0, "yes")
    assert m.get_accuracy("yes") == f"{2/3*100:.6f}"
    assert m.get_average_score() == f"{2/3*100:.6f}"


def test_mcq_scoring_accuracy(tmp_path):
    out = str(tmp_path)
    qa_file = os.path.join(out, "qa.json")
    with open(qa_file, "w") as f:
        json.dump([], f)
    with open(os.path.join(out, "pred.json"), "w") as f:
        for i, (pred, ans) in enumerate([("A", 0), ("B", 0), ("C", 2),
                                         ("D", 3)]):
            f.write(json.dumps({"id": str(i), "pred": pred, "answer": ans,
                                "a_type": "x"}) + "\n")
    assert calc_mcq_result(out, 1, qa_file)["acc"] == "75.000000"


SRT = """1
00:00:01,000 --> 00:00:04,000
Hello <i>world</i>.

2
00:00:05,500 --> 00:00:08,000
Second line
continues here.

3
00:01:00,000 --> 00:01:02,000
Much later.
"""


def test_subtitles():
    cues = subtitles.parse_srt(SRT)
    assert len(cues) == 3
    assert cues[0]["start"] == 1.0 and cues[0]["end"] == 4.0
    assert cues[0]["text"] == "Hello world."
    assert cues[1]["text"] == "Second line continues here."
    assert cues[2]["start"] == 60.0
    assert subtitles.subtitles_for_frames(cues, [2.0, 6.0, 30.0]) == \
        "Hello world.\nSecond line continues here."
    assert subtitles.subtitles_for_frames(cues, [1.5, 3.0]) == "Hello world."


def test_vcg_consistency_template_fields():
    split, system, template = gpt_judge.VCG_DIMENSIONS["5_consistency"]
    assert split == "consistency"
    text = template.format(question1="q1", question2="q2", answer="a",
                           pred1="p1", pred2="p2", id=0, video_id="v")
    assert "q1" in text and "p2" in text


# ---------------------------------------------------------------------------
# frame sampling and frame files
# ---------------------------------------------------------------------------

def test_frame_sampling_modes(tmp_path):
    """The reference's modes, each equal to JAX's: linspace, fps
    (uncapped), tight fps4 pairs (an odd count rounded down), rvs_movie
    duplicate pairs, --reproduce."""
    from flash_vstream_tpu.eval.inference_mcq_vqa import (
        sample_frame_paths as jax_sample)
    dirs = {}
    for name in ("plain", "frames_fps4"):
        d = tmp_path / name / "vid"
        d.mkdir(parents=True)
        for t in range(40):
            (d / f"frame_{t:06d}.jpg").write_bytes(b"x")
        dirs[name] = str(d)
    plain, fps4 = dirs["plain"], dirs["frames_fps4"]
    cases = [((plain, None, 8), {}), ((plain, 0.5, None), {}),
             ((plain, 0.5, 8), {}), ((fps4, None, 8), {}),
             ((fps4, None, 7), {}), ((plain, None, 8),
                                     {"dataset": "rvs_movie"}),
             ((plain, None, None), {"reproduce": True}),
             ((plain, None, 64), {})]
    for args, kw in cases:
        assert worker.sample_frame_paths(*args, **kw) == jax_sample(
            *args, **kw), (args, kw)
    out = worker.sample_frame_paths(plain, None, 8)
    assert len(out) == 8 and out == sorted(out)
    assert len(worker.sample_frame_paths(plain, 0.5, 8)) == 20
    out = worker.sample_frame_paths(fps4, None, 8)
    for a, b in zip(out[::2], out[1::2]):
        assert worker._frame_index(os.path.basename(b)) == \
            worker._frame_index(os.path.basename(a)) + 1
    out = worker.sample_frame_paths(plain, None, 8, dataset="rvs_movie")
    assert len(out) == 8 and all(a == b for a, b in zip(out[::2], out[1::2]))
    assert len(worker.sample_frame_paths(plain, None, None,
                                         reproduce=True)) == 10


def test_npy_and_jpeg_frames_agree(tmp_path):
    """A JPEG frame directory and the `.npy` directory of its decoded
    frames load to the same arrays, in the same order."""
    jpg, npy = tmp_path / "jpg", tmp_path / "npy"
    jpg.mkdir()
    npy.mkdir()
    rng = np.random.default_rng(0)
    for i in (0, 2, 10):
        img = rng.integers(0, 255, (56, 72, 3), dtype=np.uint8)
        Image.fromarray(img).save(jpg / f"frame_{i}.jpg")
        np.save(npy / f"frame_{i}.npy",
                np.asarray(Image.open(jpg / f"frame_{i}.jpg").convert("RGB")))
    a = worker.load_frames(worker.sample_frame_paths(str(jpg), None, None))
    b = worker.load_frames(worker.sample_frame_paths(str(npy), None, None))
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.uint8 and np.array_equal(x, y)


# ---------------------------------------------------------------------------
# the worker and the launcher
# ---------------------------------------------------------------------------

def test_worker_matches_jax(tmp_path, monkeypatch):
    """One MCQ sample and one consistency pair (pred1, pred2) over the same
    parameters and frames: the port's answers file holds JAX's preds."""
    import jax
    import jax.numpy as jnp
    from flash_vstream_tpu.core.config import tiny_qwen_config
    from flash_vstream_tpu.eval import inference_mcq_vqa as jworker
    from flash_vstream_tpu.models.vstream_qwen import init_qwen_params
    from flash_vstream_tpu.preprocess import image as jimage
    from flash_vstream_tpu.preprocess.qwen_processor import (
        make_byte_qwen_tokenizer as jtok)
    from flash_vstream_tpu.runtime.pipeline import QwenPipeline as JPipeline
    from flash_vstream_tpu_torch.preprocess.qwen_processor import (
        make_byte_qwen_tokenizer)
    from flash_vstream_tpu_torch.runtime import pipeline as tpipeline
    from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy
    monkeypatch.setattr(jimage, "qwen_device_preprocess", functools.partial(
        jimage.qwen_device_preprocess, dtype=jnp.float32))
    monkeypatch.setattr(tpipeline, "qwen_device_preprocess",
                        functools.partial(tpipeline.qwen_device_preprocess,
                                          dtype=torch.float32))
    root = str(tmp_path / "data")
    frame_dir, _ = make_fake_dataset(root, n_q=0)
    qa = [{"id": "m", "video_id": "vid0", "answer": 1,
           "question": "Which?\nA. one\nB. two\nC. three\nD. four"},
          {"id": "c", "video_id": "vid1", "answer": "x",
           "question1": "What occurs?", "question2": "Describe it."}]
    qa_file = os.path.join(root, "qa.json")
    with open(qa_file, "w") as f:
        json.dump(qa, f)
    cfg = tiny_qwen_config()
    jparams = init_qwen_params(jax.random.PRNGKey(0), cfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    argv = ["--dataset", "mvbench", "--video-dir", frame_dir, "--data-file",
            qa_file, "--max-frames", "4", "--max-new-tokens", "6"]
    want = _records(jworker.run_inference(
        jworker.make_parser().parse_args(
            argv + ["--output-dir", str(tmp_path / "jax")]),
        pipeline=JPipeline(jparams, cfg, jtok(), max_len=1024)))
    got = _records(worker.run_inference(
        worker.make_parser().parse_args(
            argv + ["--output-dir", str(tmp_path / "port")]),
        pipeline=tpipeline.QwenPipeline(tparams, cfg,
                                        make_byte_qwen_tokenizer(),
                                        max_len=1024)))
    assert [r["id"] for r in got] == ["m", "c"]
    assert got == want
    assert "pred" in got[0] and "pred1" in got[1] and "pred2" in got[1]


def test_eval_any_dataset_dry_run(tmp_path):
    root, out = str(tmp_path / "data"), str(tmp_path / "out")
    make_fake_dataset(root)
    eval_any_dataset.main(["--dataset", "mvbench", "--data-root", root,
                           "--output-dir", out, *DRY])
    preds = _records(os.path.join(out, "pred.json"))
    assert len(preds) == 4 and all("pred" in p for p in preds)
    assert len(json.load(open(os.path.join(out, "result.json")))) == 4
    assert os.path.exists(os.path.join(out, "result.csv"))


def test_eval_resume(tmp_path):
    """Already-answered ids are skipped on restart; a sample whose video is
    missing is printed and left out, as the reference does."""
    root, out = str(tmp_path / "data"), str(tmp_path / "out")
    _, qa_file = make_fake_dataset(root)
    qa = json.load(open(qa_file)) + [{"id": "9", "video_id": "gone",
                                       "question": "Q?", "answer": 0}]
    with open(qa_file, "w") as f:
        json.dump(qa, f)
    os.makedirs(out)
    with open(os.path.join(out, "pred.json"), "w") as f:
        for i, p in ((0, "A"), (1, "B")):
            f.write(json.dumps({"id": str(i), "video_id": f"vid{i}",
                                "answer": i, "pred": p,
                                "question": f"Q{i}?"}) + "\n")
    eval_any_dataset.main(["--dataset", "mvbench", "--data-root", root,
                           "--output-dir", out, *DRY])
    preds = _records(os.path.join(out, "pred.json"))
    assert [p["id"] for p in preds] == ["0", "1", "2", "3"]
    assert preds[0]["pred"] == "A" and preds[1]["pred"] == "B"


def test_unknown_dataset_errors(tmp_path):
    with pytest.raises(SystemExit):
        eval_any_dataset.main(["--dataset", "nope",
                               "--output-dir", str(tmp_path)])


def make_fake_videochatgpt(root, n_videos=2, n_frames=4):
    frame_dir = os.path.join(root, "VideoChatGPTBench",
                             "video_10000frames_high_fps1")
    rng = np.random.default_rng(0)
    for v in range(n_videos):
        d = os.path.join(frame_dir, f"vid{v}")
        os.makedirs(d, exist_ok=True)
        for i in range(n_frames):
            np.save(os.path.join(d, f"frame_{i:06d}.npy"),
                    rng.integers(0, 255, size=(56, 56, 3), dtype=np.uint8))
    base = os.path.join(root, "VideoChatGPTBench")
    for split in ("generic", "temporal"):
        qa = [{"id": f"{split}{i}", "video_id": f"vid{i % n_videos}",
               "question": f"What happens ({split} {i})?",
               "answer": f"something {i}"} for i in range(2)]
        with open(os.path.join(base, f"test_{split}_qa.json"), "w") as f:
            json.dump(qa, f)
    qa = [{"id": f"cons{i}", "video_id": f"vid{i % n_videos}",
           "question1": f"What occurs in the clip ({i})?",
           "question2": f"Describe what happens ({i}).",
           "answer": f"something {i}"} for i in range(2)]
    with open(os.path.join(base, "test_consistency_qa.json"), "w") as f:
        json.dump(qa, f)


def test_videochatgpt_three_splits(tmp_path, monkeypatch):
    """Three splits inferred into their own directories (consistency
    samples ask both paraphrases) and the five judge dimensions, the
    judge's `urlopen` stubbed: it sees each request and answers 4."""
    root, out = str(tmp_path / "data"), str(tmp_path / "out")
    make_fake_videochatgpt(root)
    seen = []

    class Reply:
        def __init__(self, req):
            seen.append(json.loads(req.data))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def read(self):
            return json.dumps({"choices": [
                {"message": {"content": "{'score': 4}"}}]}).encode()

    monkeypatch.setenv("OPENAI_API_KEY", "test-key")
    monkeypatch.setattr(gpt_judge.urllib.request, "urlopen",
                        lambda req, timeout: Reply(req))
    eval_any_dataset.main(["--dataset", "videochatgpt", "--data-root", root,
                           "--output-dir", out, *DRY])
    for split in ("generic", "temporal", "consistency"):
        preds = _records(os.path.join(out, split, "pred.json"))
        assert len(preds) == 2
        keys = ("pred1", "pred2") if split == "consistency" else ("pred",)
        assert all(k in p for p in preds for k in keys)
    result = json.load(open(os.path.join(out, "result.json")))
    assert set(result) == {"1_correctness", "2_detailed_orientation",
                           "3_context", "4_temporal", "5_consistency"}
    assert result["5_consistency"] == "4.000000"
    assert seen and all(r["messages"] for r in seen)


def test_model_path_worker(tmp_path):
    """--model-path: the worker loads a checkpoint the port wrote (bf16,
    its config.json, its HF tokenizer) and answers every sample, as a
    pipeline built on the loaded parameters does."""
    from torch_ckpt import write_tiny_checkpoint
    from flash_vstream_tpu_torch.runtime.generation import GenerationConfig
    ckpt = str(tmp_path / "ckpt")
    write_tiny_checkpoint(ckpt)
    root = str(tmp_path / "data")
    frame_dir, qa_file = make_fake_dataset(root, n_q=2, npy=True)
    args = worker.make_parser().parse_args(
        ["--model-path", ckpt, "--device", "cpu", "--dataset", "mvbench",
         "--video-dir", frame_dir, "--data-file", qa_file, "--output-dir",
         str(tmp_path / "out"), "--max-frames", "4", "--max-new-tokens", "4"])
    pipe = worker.build_pipeline(args)
    assert pipe.params["llm"]["embed"].dtype == torch.bfloat16
    assert pipe.tokenizer.eos_token_id == 151645
    recs = _records(worker.run_inference(args, pipeline=pipe))
    assert [r["id"] for r in recs] == ["0", "1"]
    gen = GenerationConfig(max_new_tokens=4, eos_token_ids=(151645,))
    frames = worker.load_frames(worker.sample_frame_paths(
        os.path.join(frame_dir, "vid0"), None, 4))
    q, _ = worker.build_question(json.load(open(qa_file))[0], "mvbench")
    assert recs[0]["pred"] == pipe.answer(frames, q + "\nBest option: (",
                                          gen=gen)


def test_eval_chunked_subprocess(tmp_path, monkeypatch):
    """--num-chunks 2: two worker subprocesses (on --device cpu, passed on
    to them; one thread each, as the test runners share the cores) over
    `.npy` frames; their answers files hold every id and scoring merges
    them."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    root, out = str(tmp_path / "data"), str(tmp_path / "out")
    make_fake_dataset(root, n_q=4, npy=True)
    eval_any_dataset.main(["--dataset", "mvbench", "--data-root", root,
                           "--output-dir", out, "--num-chunks", "2", *DRY])
    files = sorted(glob.glob(os.path.join(out, "2_*.json")))
    assert [os.path.basename(f) for f in files] == ["2_0.json", "2_1.json"]
    ids = sorted(r["id"] for f in files for r in _records(f))
    assert ids == ["0", "1", "2", "3"]
    assert len(json.load(open(os.path.join(out, "result.json")))) == 4
