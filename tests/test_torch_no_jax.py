"""The port runs without JAX and without the JAX package: a tiny ingest +
answer, a tiny LoRA training step, an answer over an int4 decoder (prefill
and a decode step), the --load-4bit dry-run server, the HTTP server
(frames, a preemptible speculative answer, a sampled SSE answer), a
session's clone, save/load and streamed answer, the plain versions of
P1 and P2, the ViT and gather probes (the ViT probe with --int8, so
w8a8), the int4 probe's variants (P3, P4) and its `main` and `main2` on
the CPU in a fresh interpreter leave
`jax` and `flash_vstream_tpu` out of sys.modules (the tests' own conftest
imports jax, hence the subprocess); no source file of the port imports
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
with tempfile.TemporaryDirectory() as out:
    res = run_training(make_parser().parse_args([
        "--dry-run", "--device", "cpu", "--output-dir", out, "--max-steps", "1",
        "--grad-accum", "1", "--max-frames", "4", "--frame-bucket", "4",
        "--max-len", "128", "--max-pixels", str(56 * 56), "--lora-rank", "2"]))
assert len(res["losses"]) == 1 and np.isfinite(res["losses"][0])
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
summary = main(["--dry-run", "--device", "cpu", "--load-4bit",
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
            "flash_vstream_tpu_torch/scripts/probe_int4_variants.py"} <= names
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
