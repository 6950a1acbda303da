"""The port runs without JAX: a tiny ingest + answer on the CPU in a fresh
interpreter leaves `jax` out of sys.modules (the tests' own conftest imports
jax, hence the subprocess), and no source file of the port imports it."""
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = """
import sys
import numpy as np
import torch
from flash_vstream_tpu.core.config import tiny_qwen_config
from flash_vstream_tpu_torch.models.vstream_qwen import VStreamQwen, init_qwen_params
from flash_vstream_tpu_torch.preprocess.qwen_processor import make_byte_qwen_tokenizer
from flash_vstream_tpu_torch.runtime.generation import GenerationConfig
from flash_vstream_tpu_torch.runtime.streaming import QwenStreamSession
torch.set_num_threads(1)
cfg = tiny_qwen_config()
model = VStreamQwen(cfg, init_qwen_params(cfg, torch.Generator().manual_seed(0)))
sess = QwenStreamSession(model, make_byte_qwen_tokenizer(), frame_hw=(56, 56),
                         clip_size=2, bank_size=8, max_len=512)
rng = np.random.default_rng(0)
for _ in range(6):
    sess.ingest_frames([rng.integers(0, 256, (56, 56, 3), dtype=np.uint8)
                        for _ in range(2)])
toks = sess.answer_tokens(*sess._published, "what?",
                          GenerationConfig(max_new_tokens=4))
assert sess.n_frames == 6 and 1 <= len(toks) <= 4
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("OK")
"""


def test_port_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK"


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    files = sorted((ROOT / "flash_vstream_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert files
    for f in files:
        assert not pat.search(f.read_text()), f
