"""The port runs without JAX and without the JAX package: first the
offline path without `safetensors`, `transformers` or PIL (a tiny
checkpoint written and loaded by the port's own safetensors code, a video
and an image answered through QwenPipeline, the eval worker over `.npy`
frames; none of the three is in sys.modules afterwards, as on the card's
machine, which has none of them), then a tiny ingest +
answer (also over an int8 KV cache, in prefill and decode chunks), a tiny
LoRA training step, two QLoRA steps over an int4 base with an image item,
--export-merged, merge_lora_weights.py and apply_lora_adapter, an answer
over an int4 decoder (prefill and a decode step), the --load-4bit
--kv-int8 dry-run server, the HTTP server
(frames, a preemptible speculative answer, a sampled SSE answer), a
session's clone, save/load and streamed answer, the plain versions of
P1 and P2, the ViT and gather probes (the ViT probe with --int8, so
w8a8), the int4 probe's variants (P3, P4) and its `main` and `main2`,
and the LLaVA family with PIL blocked (every new module imported, a tiny
LLaVA checkpoint written and loaded, a video and an image through
LLaVAPipeline, a stream answered speculatively, the --model-family llava
--load-4bit --kv-int8 dry-run server; frames resized by the numpy
resampling; the LLaVA trainer's raw-media and feature dry runs,
extract_features over `.npy` frame directories and the feature eval
launcher over what it wrote), both multi-stream engines, the threaded ingest and the gmm
consolidation, the video I/O library (the fixture's MJPEG mp4 and its JPEG
directory decoded, the prefetch loader, extract_frames --format npy) and
the driver-entry forward at the tiny config, the training-across-ranks
modules (tensor parallelism's too), the memory plan at --tiny and a ZeRO-3 offload
Trainer step at world 1 on the CPU in a fresh interpreter leave
`jax` and `flash_vstream_tpu` out of sys.modules (the tests' own conftest
imports jax, hence the subprocess), nor does a spawned gloo rank; no
source file of the port imports
either; and the port's copy of the config dataclasses equals the JAX
package's field for field."""
import dataclasses
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = """
import sys, tempfile
import numpy as np
import torch
from flash_vstream_tpu_torch.core.config import tiny_qwen_config
from flash_vstream_tpu_torch.models.vstream_qwen import VStreamQwen, init_qwen_params
from flash_vstream_tpu_torch.preprocess.qwen_processor import make_byte_qwen_tokenizer
from flash_vstream_tpu_torch.runtime.generation import GenerationConfig
from flash_vstream_tpu_torch.runtime.streaming import QwenStreamSession
from flash_vstream_tpu_torch.train.finetune_flash import make_parser, run_training
torch.set_num_threads(1)
cfg = tiny_qwen_config()
import json, os
from flash_vstream_tpu_torch.eval import inference_mcq_vqa as worker
from flash_vstream_tpu_torch.runtime.pipeline import QwenPipeline
from flash_vstream_tpu_torch.weights.convert import load_qwen_checkpoint, qwen_config_from_hf
from flash_vstream_tpu_torch.weights.export import (
    export_llama, export_qwen_vit, hf_qwen_config, save_hf_checkpoint)
params = init_qwen_params(cfg, torch.Generator().manual_seed(0), "cpu")
rng = np.random.default_rng(0)
frames = [rng.integers(0, 256, (112, 112, 3), dtype=np.uint8) for _ in range(12)]
with tempfile.TemporaryDirectory() as d:
    sd = export_llama(params["llm"], cfg.llm)
    sd.update(export_qwen_vit(params["vit"], cfg.vit))
    assert len(save_hf_checkpoint(d + "/ckpt", sd, config=hf_qwen_config(cfg),
                                  max_shard_bytes=300000)) > 1
    lcfg = qwen_config_from_hf(d + "/ckpt")
    loaded = load_qwen_checkpoint(d + "/ckpt", lcfg, device="cpu")
    assert torch.equal(loaded["vit"]["layers"]["attn"]["wk"]["w"],
                       params["vit"]["layers"]["attn"]["wk"]["w"])
    pipe = QwenPipeline(loaded, lcfg, make_byte_qwen_tokenizer(), max_len=1024)
    gen = GenerationConfig(max_new_tokens=3)
    assert isinstance(pipe.answer(frames, "what?", gen=gen), str)
    assert 1 <= len(pipe.answer_image_tokens(frames[0], "what?", gen)) <= 3
    os.makedirs(d + "/frames/v0")
    for i, f in enumerate(frames[:4]):
        np.save(d + f"/frames/v0/frame_{i:06d}.npy", f)
    with open(d + "/qa.json", "w") as f:
        json.dump([{"id": "0", "video_id": "v0", "question": "Q?",
                    "answer": 0}], f)
    out = worker.run_inference(worker.make_parser().parse_args([
        "--dataset", "mvbench", "--video-dir", d + "/frames", "--data-file",
        d + "/qa.json", "--output-dir", d + "/out", "--max-frames", "4",
        "--max-new-tokens", "3", "--device", "cpu"]), pipeline=pipe)
    with open(out) as f:
        assert [json.loads(line)["id"] for line in f] == ["0"]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("safetensors", "transformers", "PIL"))
assert not bad, bad
model = VStreamQwen(cfg, init_qwen_params(cfg, torch.Generator().manual_seed(0), "cpu"))
sess = QwenStreamSession(model, make_byte_qwen_tokenizer(), frame_hw=(56, 56),
                         clip_size=2, bank_size=8, max_len=512)
rng = np.random.default_rng(0)
for _ in range(6):
    sess.ingest_frames([rng.integers(0, 256, (56, 56, 3), dtype=np.uint8)
                        for _ in range(2)])
toks = sess.answer_tokens(*sess._published, "what?",
                          GenerationConfig(max_new_tokens=4))
assert sess.n_frames == 6 and 1 <= len(toks) <= 4
from flash_vstream_tpu_torch.parallel.serve import make_serve_placement
from flash_vstream_tpu_torch.parallel.sharding import create_mesh, zero_shardings
placed = QwenStreamSession(model, make_byte_qwen_tokenizer(), frame_hw=(56, 56),
                           clip_size=2, bank_size=8, max_len=512,
                           placement=make_serve_placement(1, 2, ["cpu"] * 3))
placed.load_session(sess.save_session(tempfile.mkdtemp() + "/p.pt"))
assert placed.answer_tokens(*placed._published, "what?",
                            GenerationConfig(max_new_tokens=4)) == toks
assert list(placed.answer_stream("what?", GenerationConfig(max_new_tokens=4))) \
    == list(sess.answer_stream("what?", GenerationConfig(max_new_tokens=4)))
assert zero_shardings(create_mesh(2, 1, ["cpu"] * 2),
                      model.llm.tree())["embed"] == ("tp", "dp")
sess8 = QwenStreamSession(model, make_byte_qwen_tokenizer(), frame_hw=(56, 56),
                          clip_size=2, bank_size=8, max_len=512,
                          kv_cache_dtype=torch.int8)
sess8.load_session(sess.save_session(tempfile.mkdtemp() + "/s.pt"))
toks = sess8.answer_tokens(*sess8._published, "what?",
                           GenerationConfig(max_new_tokens=4,
                                            preemptible_chunk=2,
                                            prefill_chunk=64))
assert 1 <= len(toks) <= 4
with tempfile.TemporaryDirectory() as out:
    res = run_training(make_parser().parse_args([
        "--dry-run", "--device", "cpu", "--output-dir", out, "--max-steps", "1",
        "--grad-accum", "1", "--max-frames", "4", "--frame-bucket", "4",
        "--max-len", "128", "--max-pixels", str(56 * 56), "--lora-rank", "2"]))
assert len(res["losses"]) == 1 and np.isfinite(res["losses"][0])
from flash_vstream_tpu_torch.scripts import merge_lora_weights
from flash_vstream_tpu_torch.train.checkpoint import save_checkpoint
from flash_vstream_tpu_torch.train.finetune_flash import build_synthetic_dataset
from flash_vstream_tpu_torch.weights.convert import apply_lora_adapter
from flash_vstream_tpu_torch.weights.quantize import quantize_params4
with tempfile.TemporaryDirectory() as out:
    data, frames = build_synthetic_dataset(out + "/data", n_items=1,
                                           n_frames=4, n_images=1)
    res = run_training(make_parser().parse_args([
        "--dry-run", "--device", "cpu", "--output-dir", out + "/run",
        "--data-path", data, "--video-dir", frames, "--max-steps", "2",
        "--grad-accum", "1", "--max-frames", "4", "--frame-bucket", "4",
        "--max-len", "128", "--max-pixels", str(56 * 56), "--lora-rank", "2",
        "--int8-base", "--export-merged", "--save-steps", "1"]))
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    save_checkpoint(out + "/base", 0, quantize_params4(params))
    import contextlib, io
    with contextlib.redirect_stdout(io.StringIO()):
        merge_lora_weights.main(["--base-checkpoint", out + "/base",
                                 "--lora-checkpoint", out + "/run", "--output",
                                 out + "/m.safetensors", "--rank", "2",
                                 "--device", "cpu"])
merged = apply_lora_adapter(params["llm"], {
    "layers.0.self_attn.q_proj.lora_A.weight": np.ones((2, 64), np.float32),
    "layers.0.self_attn.q_proj.lora_B.weight": np.ones((64, 2), np.float32)},
    alpha=2.0, rank=2)
assert not torch.equal(merged["layers"]["attn"]["wq"]["w"],
                       params["llm"]["layers"]["attn"]["wq"]["w"])
from flash_vstream_tpu_torch.weights.quantize import QuantWeight4, quantize_params4
qmodel = VStreamQwen(cfg, {"vit": model.vit.tree(),
                          "llm": quantize_params4(model.llm.tree())})
assert isinstance(qmodel.llm.tree()["lm_head"], QuantWeight4)
qsess = QwenStreamSession(qmodel, make_byte_qwen_tokenizer(), frame_hw=(56, 56),
                          clip_size=2, bank_size=8, max_len=512)
qsess.ingest_frames([rng.integers(0, 256, (56, 56, 3), dtype=np.uint8)
                     for _ in range(2)])
toks = qsess.answer_tokens(*qsess._published, "what?",
                           GenerationConfig(max_new_tokens=2))
assert 1 <= len(toks) <= 2
from flash_vstream_tpu_torch.serve.cli_server import main
summary = main(["--dry-run", "--device", "cpu", "--load-4bit", "--kv-int8",
                "--synthetic-frames", "4", "--play_speed", "0",
                "--question", "Q?", "--question_interval", "1000",
                "--max-new-tokens", "2"])
assert summary["frames_ingested"] == 4 and len(summary["answers"]) == 1
from flash_vstream_tpu_torch.serve import http_server
import io, json, threading, urllib.request
httpd = http_server.make_server(["--dry-run", "--device", "cpu", "--port",
                                 "0", "--max-new-tokens", "3", "--preempt",
                                 "2"])
threading.Thread(target=httpd.serve_forever, daemon=True).start()
base = f"http://127.0.0.1:{httpd.server_address[1]}"
def post(path, data, ctype="application/json"):
    r = urllib.request.Request(base + path, data=data, method="POST")
    r.add_header("Content-Type", ctype)
    with urllib.request.urlopen(r, timeout=60) as resp:
        return resp.read()
post("/v1/streams", json.dumps({"id": "a"}).encode())
buf = io.BytesIO()
np.save(buf, rng.integers(0, 256, (3, 56, 56, 3), dtype=np.uint8))
post("/v1/streams/a/frames?flush=1", buf.getvalue(), "application/octet-stream")
ans = json.loads(post("/v1/streams/a/answer", json.dumps(
    {"question": "Q?", "preemptible_chunk": 1, "speculative_k": 2}).encode()))
sse = post("/v1/streams/a/answer", json.dumps(
    {"question": "Q?", "stream": True, "temperature": 0.7}).encode())
assert isinstance(ans["answer"], str) and sse.endswith(b"data: [DONE]\\n\\n")
httpd.shutdown(); httpd.server_close()
clone = sess.clone_fresh()
with tempfile.TemporaryDirectory() as d:
    clone.load_session(sess.save_session(d + "/s.pt"))
assert clone.n_frames == sess.n_frames
assert isinstance("".join(clone.answer_stream("what?")), str)
from flash_vstream_tpu_torch.kernels.bank_gather import bank_gather
from flash_vstream_tpu_torch.kernels.frame_attention import frame_attention
from flash_vstream_tpu_torch.scripts import probe_bank_gather, probe_vit_variants
bank = torch.randn(6, 2, 8)
assert torch.equal(bank_gather(bank, torch.tensor([5, 0, 5], dtype=torch.int32)),
                   bank[[5, 0, 5]])
q = torch.randn(2, 4, 9, 8)
assert frame_attention(q, q, q, head_block=2).shape == q.shape
import contextlib, io
with contextlib.redirect_stdout(io.StringIO()):
    probe_bank_gather.main(["--device", "cpu", "--t", "16", "--k", "3",
                            "--p", "2", "--d", "16", "--iters", "2"])
    probe_vit_variants.main(["--device", "cpu", "--side", "56", "--clip", "4",
                             "--layers", "1", "--iters", "1", "--trials", "1",
                             "--modes", "base,framekernel", "--int8"])
    from flash_vstream_tpu_torch.scripts import probe_int4_variants
    tiny = ["--device", "cpu", "--din", "256", "--dout", "256", "--blk",
            "128", "--iters", "1", "--trials", "1"]
    assert len(probe_int4_variants.main(tiny)) == 5
    assert len(probe_int4_variants.main2(tiny + ["--which", "v6,v7"])) == 2
sys.modules["PIL"] = None     # no PIL, as on the card's machine
import flash_vstream_tpu_torch.models.clip_vit, flash_vstream_tpu_torch.models.projector
import flash_vstream_tpu_torch.models.star_memory, flash_vstream_tpu_torch.ops.ntm
import flash_vstream_tpu_torch.ops.sequential
from flash_vstream_tpu_torch.core.config import tiny_llava_config
from flash_vstream_tpu_torch.models.vstream_llava import init_llava_params
from flash_vstream_tpu_torch.preprocess.tokenizer import ByteTokenizer
from flash_vstream_tpu_torch.runtime.pipeline import LLaVAPipeline
from flash_vstream_tpu_torch.runtime.streaming import LLaVAStreamSession
from flash_vstream_tpu_torch.weights.convert import load_pretrained_model
from flash_vstream_tpu_torch.weights.export import export_llava_checkpoint
lcfg = tiny_llava_config()
lp = init_llava_params(lcfg, torch.Generator().manual_seed(0), "cpu")
with tempfile.TemporaryDirectory() as d:
    save_hf_checkpoint(d + "/llava", export_llava_checkpoint(lp, lcfg),
                       max_shard_bytes=300000)
    lp2 = load_pretrained_model(d + "/llava", lcfg, device="cpu")
assert torch.equal(lp2["ntm"].wq, lp["ntm"].wq)
assert torch.equal(lp2["vit"]["pos_embed"], lp["vit"]["pos_embed"])
lframes = [rng.integers(0, 256, (60, 90, 3), dtype=np.uint8) for _ in range(5)]
lpipe = LLaVAPipeline(lp2, lcfg, ByteTokenizer(), max_len=1024)
gen = GenerationConfig(max_new_tokens=3)
assert 1 <= len(lpipe.answer_tokens(lframes, "what?", gen)) <= 3
assert isinstance(lpipe.answer_image(lframes[0], "what?", gen), str)
lsess = LLaVAStreamSession(lp2, lcfg, ByteTokenizer(), clip_size=2, max_len=1024)
for i in range(0, 5, 2):
    lsess.ingest_frames(lframes[i:i + 2])
assert lsess.n_frames == 5
assert 1 <= len(lsess.answer_tokens(*lsess._published, "what?", GenerationConfig(
    max_new_tokens=3, speculative_k=2))) <= 3
summary = main(["--model-family", "llava", "--dry-run", "--device", "cpu",
                "--load-4bit", "--kv-int8", "--synthetic-frames", "4",
                "--play_speed", "0", "--question", "Q?",
                "--question_interval", "1000", "--max-new-tokens", "2"])
assert summary["frames_ingested"] == 4 and len(summary["answers"]) == 1
from flash_vstream_tpu_torch.runtime.streaming import (
    MultiStreamEngine, QwenMultiStreamEngine, ThreadedIngestor)
qframe = lambda: rng.integers(0, 256, (56, 56, 3), dtype=np.uint8)
qeng = QwenMultiStreamEngine(model, make_byte_qwen_tokenizer(), 2,
                             frame_hw=(56, 56), clip_size=2, bank_size=4,
                             max_len=512)
for _ in range(3):
    qeng.ingest([[qframe(), qframe()], [qframe()]])
assert qeng.n_frames == (3, 3)
assert len(qeng.answer_all(["a?", "b?"], GenerationConfig(max_new_tokens=2))) == 2
leng = MultiStreamEngine(lp2, lcfg, ByteTokenizer(), 2, clip_size=2,
                         max_len=1024)
leng.ingest([lframes[:2], lframes[2:3]])
assert leng.n_frames == (2, 1)
assert isinstance(leng.answer(1, "what?", GenerationConfig(max_new_tokens=2)), str)
ing = ThreadedIngestor(sess.clone_fresh(), [qframe() for _ in range(4)],
                       fps=0, clip_size=2).start()
assert ing.wait(timeout=60) and ing.frames_ingested == 4
import dataclasses
from flash_vstream_tpu_torch.models.flash_memory import flash_consolidate
out = flash_consolidate(
    dataclasses.replace(cfg.flash_memory, temporal_method="gmm"),
    torch.randn(6, 16, 32), torch.randn(6, 4, 32))
assert out.tem_x.shape == (cfg.flash_memory.csm_grid_len, 4, 32)
from flash_vstream_tpu_torch.train import train as llava_train
from flash_vstream_tpu_torch.eval import eval_any_dataset_features, model_video_qa
from flash_vstream_tpu_torch.scripts import extract_features
with tempfile.TemporaryDirectory() as d:
    res = llava_train.run_training(llava_train.make_parser().parse_args(
        ["--dry-run", "--synthetic-raw", "--device", "cpu", "--output-dir",
         d + "/raw", "--max-steps", "3", "--frame-bucket", "4",
         "--pre-len", "16", "--post-len", "32", "--text-len", "64"]))
    assert set(res["modalities"]) == {"video", "image", "text"}
    res = llava_train.run_training(llava_train.make_parser().parse_args(
        ["--dry-run", "--device", "cpu", "--stage", "pretrain",
         "--output-dir", d + "/feat", "--max-steps", "2", "--frame-bucket",
         "8", "--pre-len", "16", "--post-len", "32"]))
    assert len(res["losses"]) == 2
    with contextlib.redirect_stdout(io.StringIO()):
        assert extract_features.main(
            ["--dry-run", "--device", "cpu", "--video_dir", d + "/raw/synthetic/media",
             "--output_dir", d + "/eval/msvd/features"]) == ["v0", "v1", "v2", "v3"]
    json.dump([{"id": 0, "video_id": "v1", "question": "What?"}],
              open(d + "/eval/msvd/test_qa.json", "w"))
    eval_any_dataset_features.main(
        ["--dataset", "msvd", "--data-root", d + "/eval", "--output-dir",
         d + "/out", "--dry-run", "--device", "cpu", "--skip-judge"])
    assert len(open(d + "/out/pred.json").readlines()) == 1
import shutil
from flash_vstream_tpu_torch.native.io import PrefetchLoader
from flash_vstream_tpu_torch.preprocess.mp4 import decode_mjpeg
from flash_vstream_tpu_torch.preprocess.video import load_frame_dir
from flash_vstream_tpu_torch.scripts import extract_frames
vd = "tests/data/video"
mj = decode_mjpeg(vd + "/scene.mp4", max_frames=4)
fd = list(load_frame_dir(vd + "/scene_frames", max_frames=4))
assert len(fd) == 4 and all(np.array_equal(a, b) for a, b in zip(mj, fd))
jpgs = [vd + "/scene_frames/" + n for n in sorted(os.listdir(vd + "/scene_frames"))]
assert len(list(PrefetchLoader(jpgs[:3], 56, 56))) == 3
with tempfile.TemporaryDirectory() as d:
    os.makedirs(d + "/v")
    shutil.copy(vd + "/scene.mp4", d + "/v/a.mp4")
    with contextlib.redirect_stdout(io.StringIO()):
        assert extract_frames.main(["--video_dir", d + "/v", "--frame_dir",
                                    d + "/f", "--format", "npy", "--fps", "8"]) == 1
    assert len(os.listdir(d + "/f/a")) == 16
from flash_vstream_tpu_torch.entry import entry
fn, args = entry(tiny_qwen_config(), device="cpu")
assert torch.isfinite(fn(*args).float()).all()
del sys.modules["PIL"]
from flash_vstream_tpu_torch.parallel import collectives, pipeline, sequence, tensor
from flash_vstream_tpu_torch.scripts import plan_full7b_memory
assert plan_full7b_memory.plan(tiny_llava_config(), 2, 2, seq=128, frames=8)["fits_80gb"]
from flash_vstream_tpu_torch.train.trainer import TrainConfig, Trainer
tr = Trainer(lambda p, b, k: (p["w"] * b).sum(), {"w": torch.ones(4)},
             TrainConfig(zero_stage=3, offload_moments=True, total_steps=2,
                         warmup_ratio=0.5))
assert tr.run_step(torch.ones(1, 4), 0) == 4.0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flash_vstream_tpu"))
assert not bad, bad
print("OK")
"""


def test_port_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK"


SCRIPTS = """
import sys
from flash_vstream_tpu_torch.scripts import (
    bench_attention, bench_int8_matvec, bench_train_step, probe_attn_crossover,
    probe_ingest_fusion, probe_int4_matvec, profile_ingest,
    sweep_attention_blocks)
bench_train_step.main(["--tiny", "--device", "cpu", "--steps", "1",
                       "--seq", "96", "--frames", "4", "--accum", "1",
                       "--lora-rank", "4"])
profile_ingest.main(["--device", "cpu", "--side", "56", "--layers", "1",
                     "--iters", "1", "--trials", "1", "--stages", "vit,mem"])
bench_attention.main(["--device", "cpu", "--seq", "32", "--heads", "2",
                      "--dim", "64", "--iters", "1", "--trials", "1",
                      "--calib-size", "32"])
probe_int4_matvec.main(["--device", "cpu", "--din", "256", "--dout", "384",
                        "--layers", "1", "--iters", "1", "--trials", "1"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flash_vstream_tpu"))
assert not bad, bad
print("OK")
"""


def test_new_scripts_run_without_jax():
    """The developers' instruments and bench_train_step (imported all,
    four run at tiny sizes on the CPU) leave `jax` and the JAX package out
    of sys.modules in a fresh interpreter."""
    proc = subprocess.run([sys.executable, "-c", SCRIPTS], cwd=ROOT,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "OK"


def test_ranks_run_without_jax(tmp_path):
    """A rank that the training-across-ranks tests spawn (gloo on the CPU,
    tests/torch_ranks.py) joins its group and runs a collective with
    neither `jax` nor the JAX package in sys.modules."""
    import torch
    import torch_ranks
    from flash_vstream_tpu_torch.parallel.collectives import spawn
    spawn(torch_ranks.modules_seen, 2, str(tmp_path),
          init_file=str(tmp_path / "init"))
    for r in range(2):
        assert torch.load(tmp_path / f"rank{r}.pt") == []


def test_port_sources_never_import_jax():
    """Neither `jax` nor the JAX package (`flash_vstream_tpu`, not
    followed by `_torch`) is imported by a source of the port or by
    chip_smoke.py."""
    pat = re.compile(r"^\s*(import jax|from jax"
                     r"|import flash_vstream_tpu(?!_torch)"
                     r"|from flash_vstream_tpu(?!_torch)[\s.])", re.M)
    files = sorted((ROOT / "flash_vstream_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"flash_vstream_tpu_torch/kernels/int4_variants.py",
            "flash_vstream_tpu_torch/scripts/probe_int4_variants.py",
            "flash_vstream_tpu_torch/parallel/sharding.py",
            "flash_vstream_tpu_torch/parallel/inference.py",
            "flash_vstream_tpu_torch/parallel/serve.py",
            "flash_vstream_tpu_torch/parallel/collectives.py",
            "flash_vstream_tpu_torch/parallel/pipeline.py",
            "flash_vstream_tpu_torch/parallel/sequence.py",
            "flash_vstream_tpu_torch/parallel/tensor.py",
            "flash_vstream_tpu_torch/scripts/plan_full7b_memory.py",
            "flash_vstream_tpu_torch/native/io.py",
            "flash_vstream_tpu_torch/preprocess/mp4.py",
            "flash_vstream_tpu_torch/scripts/extract_frames.py",
            "flash_vstream_tpu_torch/scripts/make_video_fixture.py",
            "flash_vstream_tpu_torch/entry.py",
            "flash_vstream_tpu_torch/scripts/bench_train_step.py",
            "flash_vstream_tpu_torch/scripts/profile_ingest.py",
            "flash_vstream_tpu_torch/scripts/probe_ingest_fusion.py",
            "flash_vstream_tpu_torch/scripts/bench_attention.py",
            "flash_vstream_tpu_torch/scripts/sweep_attention_blocks.py",
            "flash_vstream_tpu_torch/scripts/probe_attn_crossover.py",
            "flash_vstream_tpu_torch/scripts/bench_int8_matvec.py",
            "flash_vstream_tpu_torch/scripts/probe_int4_matvec.py"} <= names
    for f in files:
        assert not pat.search(f.read_text()), f
    assert pat.search("from flash_vstream_tpu.core import config")
    assert pat.search("import flash_vstream_tpu")
    assert not pat.search("from flash_vstream_tpu_torch.core import config")


def test_config_copy_matches_the_jax_package():
    """Every dataclass of the port's core/config.py has the JAX one's fields
    and defaults (`dataclasses.asdict` of a default instance), and the tiny
    configs agree, so the copy cannot drift."""
    from flash_vstream_tpu.core import config as jcfg
    from flash_vstream_tpu_torch.core import config as tcfg

    def dataclasses_of(mod):
        return {n: c for n, c in vars(mod).items()
                if dataclasses.is_dataclass(c)}
    jd, td = dataclasses_of(jcfg), dataclasses_of(tcfg)
    assert set(jd) == set(td) and jd
    for name, c in sorted(jd.items()):
        if isinstance(c, type):         # a class: its default instance
            want, got = c(), td[name]()
        else:                           # a preset instance (QWEN2_VL_VIT, ...)
            want, got = c, td[name]
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    for fn in ("tiny_qwen_config", "tiny_llava_config"):
        assert (dataclasses.asdict(getattr(tcfg, fn)())
                == dataclasses.asdict(getattr(jcfg, fn)())), fn
    assert tcfg.IGNORE_INDEX == jcfg.IGNORE_INDEX
