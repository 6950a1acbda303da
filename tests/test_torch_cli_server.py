"""The port's CLI server (serve/cli_server.py) held against the JAX server.

Both servers run --dry-run over the same parameter tree (the JAX tiny
config's, carried by `params_from_numpy` through the port's own
`build_session` and `_apply_quantization`), stream the same synthetic
frames and draw the same k-means init values (the JAX session's PRNG keys),
so the frames ingested and the greedy answers' token ids must be equal.
Quantized decoders on the CPU take the JAX package's own dequantize path,
in f32, and the ViT runs in bf16 in both; the greedy tokens must be the
same, as in tests/test_torch_streaming.py. With --w8a8-prefill both
servers set their package's process-wide switch; the prompt's prefill
(>= 128 rows) then quantizes its activations per token in both, and a
fixture turns both switches back. There the greedy ids may part, but only
at a near tie of the port's logits (`_near_ties_only`).
"""
import json

import jax
import numpy as np
import pytest
import torch

from flash_vstream_tpu.core.config import tiny_qwen_config as jax_tiny
from flash_vstream_tpu.models import layers as jlayers
from flash_vstream_tpu.models.vstream_qwen import init_qwen_params as jax_init
from flash_vstream_tpu.serve import cli_server as jcli
from flash_vstream_tpu_torch.models import layers as tlayers
from flash_vstream_tpu_torch.serve import cli_server as tcli
from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy
from flash_vstream_tpu_torch.weights.quantize import QuantWeight, QuantWeight4

torch.set_num_threads(1)

BASE = ["--model-family", "qwen", "--dry-run", "--synthetic-frames", "8",
        "--clip-size", "2", "--fps", "2", "--play_speed", "0",
        "--question", "What is happening?", "--max-new-tokens", "6"]
LONG_QUESTION = "What is happening, and which objects appear? " * 4 + "Say."


@pytest.fixture(autouse=True)
def restore_w8a8():
    was = (jlayers.W8A8_PREFILL, tlayers.W8A8_PREFILL)
    yield
    jlayers.W8A8_PREFILL, tlayers.W8A8_PREFILL = was


def _jax_draws(step, n):
    return torch.from_numpy(np.array(
        jax.random.uniform(jax.random.PRNGKey(step), (n,))))


def _run_both(monkeypatch, flags):
    """(JAX summary, port summary, JAX answer ids, port answer ids, the
    port's f32 logits of each answer's steps)."""
    jparams = jax_init(jax.random.PRNGKey(0), jax_tiny())
    jids, tids, logits = [], [], []

    def jax_build(args, build=jcli.build_session):
        sess = build(args)
        fused = sess._answer_fused

        def record(*a, **k):
            out = fused(*a, **k)
            jids.append([int(t) for t in out])
            return out
        sess._answer_fused = record
        return sess

    def port_init(cfg, generator, device=None, dtype=torch.float32):
        return params_from_numpy(jax.tree.map(np.asarray, jparams), device)

    def port_build(args, build=tcli.build_session):
        sess = build(args)
        sess._init_scores = _jax_draws
        tokens = sess.answer_tokens

        def record(*a, **k):
            out = tokens(*a, **k)
            tids.append(list(out))
            return out
        sess.answer_tokens = record
        return sess

    from flash_vstream_tpu_torch.runtime.generation import Generator
    prefill, step = Generator.prefill, Generator.step

    def record_prefill(self, *a, **k):
        out = prefill(self, *a, **k)
        logits.append([out[0].float()])
        return out

    def record_step(self, *a, **k):
        out = step(self, *a, **k)
        if logits:          # a chunked prefill records no logits
            logits[-1].append(out[0].float())
        return out
    monkeypatch.setattr(Generator, "prefill", record_prefill)
    monkeypatch.setattr(Generator, "step", record_step)
    monkeypatch.setattr(jcli, "build_session", jax_build)
    monkeypatch.setattr(tcli, "build_session", port_build)
    monkeypatch.setattr(
        "flash_vstream_tpu_torch.models.vstream_qwen.init_qwen_params",
        port_init)
    argv = BASE + flags
    want = jcli.run_server(jcli.make_parser().parse_args(argv))
    got = tcli.run_server(tcli.make_parser().parse_args(
        argv + ["--device", "cpu"]))
    return want, got, jids, tids, logits


@pytest.mark.parametrize("flags", [
    ["--load-4bit", "--question_interval", "1000"],
    ["--load-8bit", "--int8-vit", "--question_interval", "0.0001"],
    # a question of 184 bytes makes the prompt's prefill >= 128 rows,
    # which w8a8 takes (the tiny ViT's 16-token frames stay weight-only)
    ["--load-8bit", "--int8-vit", "--w8a8-prefill",
     "--question_interval", "0.0001", "--question", LONG_QUESTION],
], ids=["load_4bit", "load_8bit_int8_vit", "load_8bit_int8_vit_w8a8"])
def test_dry_run_matches_jax_server(monkeypatch, flags):
    calls = {"jax": 0, "port": 0}        # w8a8 products taken (JAX: traced)
    for name, mod in (("jax", jlayers), ("port", tlayers)):
        def spy(*a, _dot=mod._w8a8_dot, _name=name):
            calls[_name] += 1
            return _dot(*a)
        monkeypatch.setattr(mod, "_w8a8_dot", spy)
    want, got, jids, tids, logits = _run_both(monkeypatch, flags)
    w8a8 = "--w8a8-prefill" in flags
    assert jlayers.W8A8_PREFILL is tlayers.W8A8_PREFILL is w8a8
    assert (calls["jax"] > 0 and calls["port"] > 0) == w8a8, calls
    assert got["frames_ingested"] == want["frames_ingested"] == 8
    assert len(tids) == len(jids) == len(got["answers"]) >= 1
    if w8a8:
        _near_ties_only(jids, tids, logits)
    else:
        assert tids == jids
        assert [a["answer"] for a in got["answers"]] == [
            a["answer"] for a in want["answers"]]
    assert [a["frames"] for a in got["answers"]] == [
        a["frames"] for a in want["answers"]]
    for name in ("memory_latency", "llm_latency", "llm_latency_memoryio",
                 "conv_latency", "memory_latency_dispatch",
                 "memory_latency_host_preprocess"):
        assert name in got["metrics"] and name in want["metrics"], name


# w8a8 moves a projection's output by about 1e-2 of its max (per-token
# int8 activations; tests/test_torch_w8a8.py reads 0.8e-2 to 1.2e-2), and an
# activation within f32 noise of a rounding step rounds the other way in
# one package: the two servers' logits differ by that much
W8A8_TIE = 2e-2


def _near_ties_only(jids, tids, logits):
    """With w8a8 the two servers' greedy ids may part. Where they do, the
    JAX server's token must be one the port's logits rank within W8A8_TIE
    (of max |logit|) of their top: random weights give near-uniform logits
    (read on these inputs: the JAX token is the port's second, 0.0067
    below the top, 1.2% of max |logit|), so a w8a8 rounding step flips
    the argmax."""
    for j, t, steps in zip(jids, tids, logits):
        i = next((i for i, (a, b) in enumerate(zip(j, t)) if a != b), None)
        if i is None:
            assert j == t
            continue
        lg = steps[i]
        assert lg.max() - lg[j[i]] <= W8A8_TIE * lg.abs().max(), (i, j, t)


def test_quantization_flags_build_quantized_trees():
    args = tcli.make_parser().parse_args(
        ["--dry-run", "--device", "cpu", "--load-4bit", "--int8-vit"])
    sess = tcli.build_session(args)
    llm, vit = sess.model.llm.tree(), sess.model.vit.tree()
    assert isinstance(llm["layers"]["mlp"]["up"]["w"], QuantWeight4)
    assert isinstance(llm["lm_head"], QuantWeight4)
    assert isinstance(llm["embed"], torch.Tensor)            # stays as is
    assert isinstance(vit["layers"]["attn"]["wq"]["w"], QuantWeight)
    assert isinstance(vit["patch_embed"]["w"], torch.Tensor)
    assert isinstance(vit["merger"]["fc1"]["w"], torch.Tensor)
    args = tcli.make_parser().parse_args(
        ["--dry-run", "--device", "cpu", "--load-8bit"])
    llm = tcli.build_session(args).model.llm.tree()
    assert isinstance(llm["layers"]["attn"]["wq"]["w"], QuantWeight)


def test_question_intervals_output_file_and_prewarm(tmp_path):
    out = tmp_path / "summary.json"
    summary = tcli.main(BASE + [
        "--device", "cpu", "--load-4bit", "--prewarm",
        "--question_interval", "0.0001", "--output-file", str(out)])
    assert summary["frames_ingested"] == 8
    # a question after every clip (4 clips) and one after the stream
    assert len(summary["answers"]) == 5
    assert [a["frames"] for a in summary["answers"]] == [2, 4, 6, 8, 8]
    assert json.loads(out.read_text()) == json.loads(json.dumps(summary))
    assert summary["metrics"]["answer_tokens"]["count"] == 5   # after prewarm


def test_frame_directory_source(tmp_path):
    from PIL import Image
    d = tmp_path / "frames"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        Image.fromarray(rng.integers(0, 255, (56, 56, 3), dtype=np.uint8)
                        ).save(d / f"{i:06d}.jpg")
    summary = tcli.main(["--dry-run", "--device", "cpu", "--video_file",
                         str(d), "--clip-size", "2", "--play_speed", "0",
                         "--question", "Q?", "--question_interval", "1000",
                         "--max-new-tokens", "3"])
    assert summary["frames_ingested"] == 6 and len(summary["answers"]) == 1


@pytest.mark.parametrize("flag,item", [
    (["--model-family", "llava"], "A13"),
    (["--model-path", "/nonexistent"], "A10"),
    (["--kv-int8"], "A10"),
    (["--threaded-ingest"], "A15"),
    (["--ingest-devices", "1"], "A16"),
    (["--decode-devices", "1"], "A16"),
])
def test_unported_flags_raise(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        tcli.main(["--dry-run", "--device", "cpu", *flag])


def test_stream_output_same_answers(capsys):
    """--stream-output prints each answer as it decodes; the answers are
    the ones the server gives without it."""
    argv = BASE + ["--device", "cpu", "--question_interval", "0.0001"]
    plain = tcli.main(argv)
    capsys.readouterr()
    streamed = tcli.main(argv + ["--stream-output"])
    printed = capsys.readouterr().out
    assert [a["answer"] for a in streamed["answers"]] == [
        a["answer"] for a in plain["answers"]]
    assert printed.count("Q: What is happening?") == len(plain["answers"])
    assert streamed["metrics"]["conv_latency"]["count"] == 5


def test_preempt_and_prefill_chunk_same_answers(monkeypatch):
    """--preempt 2 decodes in chunks: the same answers as without it. With
    --prefill-chunk 16 too, the prompt's chunks attend to the bf16 KV cache
    where the one-shot prefill attends to its own f32 keys, in both
    packages: the answers are the JAX server's with the same flags."""
    argv = BASE + ["--device", "cpu", "--load-4bit",
                   "--question_interval", "0.0001"]
    plain = tcli.main(argv)
    chunked = tcli.main(argv + ["--preempt", "2"])
    assert [a["answer"] for a in chunked["answers"]] == [
        a["answer"] for a in plain["answers"]]
    # the final answer, as test_dry_run_matches_jax_server holds it (the
    # early ones, over one or two frame pairs, meet near-tied logits that
    # f32 rounding orders differently in the two packages)
    want, got, _, ids, _ = _run_both(monkeypatch, [
        "--load-4bit", "--question_interval", "1000", "--preempt", "2",
        "--prefill-chunk", "16"])
    assert len(ids) == len(got["answers"]) == 1
    assert [a["answer"] for a in got["answers"]] == [
        a["answer"] for a in want["answers"]]


def test_save_then_resume_continues_the_stream(tmp_path):
    """A server that resumes a saved stream answers as one session fed the
    first server's frames and then its own."""
    from flash_vstream_tpu_torch.preprocess.video import SyntheticSource
    path = str(tmp_path / "stream.pt")
    common = ["--dry-run", "--device", "cpu", "--clip-size", "2",
              "--play_speed", "0", "--question", "Q?",
              "--question_interval", "1000", "--max-new-tokens", "6"]
    first = tcli.main(common + ["--synthetic-frames", "8",
                                "--save-session", path])
    second = tcli.main(common + ["--synthetic-frames", "4",
                                 "--resume-session", path])
    assert first["frames_ingested"] == 8 and second["frames_ingested"] == 4
    sess = tcli.build_session(tcli.make_parser().parse_args(common))
    for n in (8, 4):
        src = SyntheticSource(n, 56, 56, fps=1.0)
        for i in range(0, n, 2):
            sess.ingest_frames([src[i], src[i + 1]])
    assert sess.n_frames == 6
    gen = tcli.GenerationConfig(max_new_tokens=6,
                                eos_token_ids=(sess.tokenizer.eos_token_id,))
    assert second["answers"][-1]["answer"] == sess.answer("Q?", gen)


def test_no_checkpoint_loader_yet():
    with pytest.raises(NotImplementedError, match="A10"):
        tcli.main(["--device", "cpu"])
    with pytest.raises(NotImplementedError, match="A10"):
        tcli.main(["--device", "cpu", "--load-8bit", "--w8a8-prefill"])


def test_w8a8_flag_sets_the_switch():
    """--w8a8-prefill no longer raises: `_apply_quantization` turns the
    port's switch on, as the JAX server turns its own."""
    args = tcli.make_parser().parse_args(["--w8a8-prefill"])
    tlayers.W8A8_PREFILL = False
    assert tcli._apply_quantization({}, args) == {}
    assert tlayers.W8A8_PREFILL is True


def test_session_refuses_unported_options():
    from flash_vstream_tpu_torch.runtime.streaming import QwenStreamSession
    sess = tcli.build_session(tcli.make_parser().parse_args(
        ["--dry-run", "--device", "cpu"]))
    with pytest.raises(NotImplementedError, match="A10"):
        QwenStreamSession(sess.model, sess.tokenizer,
                          kv_cache_dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="A16"):
        QwenStreamSession(sess.model, sess.tokenizer, placement=object())
