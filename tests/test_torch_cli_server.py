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
    # the int8 KV cache: the answers' k/v quantized per position in both
    ["--kv-int8", "--question_interval", "0.0001"],
    # disaggregated: the decoder split over two devices (JAX: virtual CPU
    # devices 1 and 2; the port: CPU entries), an f32 and an int4 base
    ["--ingest-devices", "1", "--decode-devices", "2",
     "--question_interval", "0.0001"],
    ["--load-4bit", "--ingest-devices", "1", "--decode-devices", "2",
     "--question_interval", "1000"],
], ids=["load_4bit", "load_8bit_int8_vit", "load_8bit_int8_vit_w8a8",
        "kv_int8", "disaggregated", "disaggregated_load_4bit"])
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


@pytest.mark.parametrize("family", ["qwen", "llava"])
def test_prewarm_frame_counts_cover_every_bucket_once(family):
    """`prewarm_frame_counts` (what --prewarm answers at) gives one frame
    count for each prompt length an answer can take, before the memory
    saturates and after, and no two of the same length."""
    sess = tcli.build_session(tcli.make_parser().parse_args(
        ["--model-family", family, "--dry-run", "--device", "cpu"]))
    if family == "qwen":
        fm = sess.cfg.flash_memory
        top = max(fm.dam_grid_len, fm.csm_grid_len) + 1

        def length(n):
            return sess._prompt_host("What is happening?", n)["S"]
    else:
        top = sess.cfg.star.video_max_frames + 4
        sess.ingest_frames([np.zeros((56, 56, 3), np.uint8)])
        snap = sess._published[0]

        def length(n):
            return sess._prompt_parts("What is happening?", snap,
                                      n)[0].shape[1]
    counts = sess.prewarm_frame_counts()
    lengths = [length(n) for n in counts]
    assert len(set(lengths)) == len(lengths) >= 1
    assert set(lengths) == {length(n) for n in range(1, top + 1)}


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
    (["--ingest-devices", "1"], "A16"),
    (["--decode-devices", "1"], "A16"),
])
def test_unported_flags_raise(flag, item):
    """The two serving flags of ROADMAP `item` raised until its serving half
    was ported (the test keeps its name): each alone now builds a
    disaggregated session, under --device cpu over one ingest and one
    decode CPU entry, and the server answers through it; the LLaVA family
    ignores them, as the JAX server does."""
    args = tcli.make_parser().parse_args(
        ["--dry-run", "--device", "cpu", *flag])
    sess = tcli.build_session(args)
    assert sess.placement is not None
    assert sess.placement.decode_mesh.shape == {"dp": 1, "tp": 1}
    summary = tcli.main(BASE + ["--device", "cpu", *flag])
    assert summary["frames_ingested"] == 8 and summary["answers"]
    assert not hasattr(tcli.build_session(tcli.make_parser().parse_args(
        ["--model-family", "llava", "--dry-run", "--device", "cpu", *flag])),
        "placement")


def test_disaggregated_dry_run_answers_as_one_device():
    """--ingest-devices 1 --decode-devices 2 --dry-run --device cpu builds a
    placed session (the decoder over two CPU shards) whose answers are the
    one-device server's."""
    from flash_vstream_tpu_torch.parallel.inference import TPDecoder
    flags = ["--ingest-devices", "1", "--decode-devices", "2"]
    sess = tcli.build_session(tcli.make_parser().parse_args(
        ["--dry-run", "--device", "cpu", *flags]))
    assert isinstance(sess.generator.llm, TPDecoder)
    assert sess.placement.decode_mesh.shape == {"dp": 1, "tp": 2}
    argv = BASE + ["--device", "cpu", "--question_interval", "0.0001"]
    want = tcli.main(argv)
    got = tcli.main(argv + flags)
    assert [a["answer"] for a in got["answers"]] == [
        a["answer"] for a in want["answers"]]
    assert len(got["answers"]) == 5


def test_too_few_cards_serve_on_one_device(monkeypatch, capsys):
    """With one visible card, --ingest-devices 1 --decode-devices 2 prints
    the JAX server's message and builds a one-device session (the model
    here on the CPU, the card's count monkeypatched)."""
    from flash_vstream_tpu_torch.runtime import pipeline
    load = pipeline.load_qwen_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(pipeline, "load_qwen_model",
                        lambda path, device, **kw: load(path, "cpu", **kw))
    sess = tcli.build_session(tcli.make_parser().parse_args(
        ["--dry-run", "--ingest-devices", "1", "--decode-devices", "2"]))
    assert sess.placement is None
    assert ("[serve] only 1 device(s) visible — disaggregation needs >= 2; "
            "falling back to the single-chip path (use --preempt so answers "
            "yield to clips)") in capsys.readouterr().out


def test_http_server_serves_placed_streams():
    """The HTTP server takes the flags through build_session: its streams
    are clones of one placed session, sharing its decoder."""
    from flash_vstream_tpu_torch.serve import http_server
    httpd = http_server.make_server(
        ["--dry-run", "--device", "cpu", "--port", "0",
         "--ingest-devices", "1", "--decode-devices", "2"])
    try:
        a = httpd.registry._new_session()
        b = httpd.registry._new_session()
        assert a.placement is not None and b.placement is a.placement
        assert b.llm is a.llm and b.state is not a.state
    finally:
        httpd.server_close()


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


def test_model_path_serves_the_checkpoint(tmp_path):
    """--model-path DIR on a checkpoint the port wrote (with an HF
    tokenizer beside it): the server loads its weights in bf16 and its
    config, and answers as a session built on the same parameters, fed the
    same frames, does. Neither flag raises ValueError."""
    from torch_ckpt import write_tiny_checkpoint
    from flash_vstream_tpu_torch.models.vstream_qwen import VStreamQwen
    from flash_vstream_tpu_torch.preprocess.video import SyntheticSource
    from flash_vstream_tpu_torch.runtime.streaming import QwenStreamSession
    ckpt = str(tmp_path / "ckpt")
    cfg, params = write_tiny_checkpoint(ckpt)
    argv = ["--model-path", ckpt, "--device", "cpu", "--frame-size", "56",
            "--synthetic-frames", "4", "--clip-size", "2", "--play_speed",
            "0", "--question", "Q?", "--question_interval", "1000",
            "--max-new-tokens", "4"]
    summary = tcli.main(argv)
    assert summary["frames_ingested"] == 4 and len(summary["answers"]) == 1
    served = tcli.build_session(tcli.make_parser().parse_args(argv))
    want = VStreamQwen(cfg, {"vit": _cast(params["vit"]),
                             "llm": _cast(params["llm"])})
    for (name, got), (_, ref) in zip(served.model.state_dict().items(),
                                     want.state_dict().items()):
        assert got.dtype == torch.bfloat16 and torch.equal(got, ref), name
    assert served.cfg.llm.vocab_size == 151680 and served.grid_hw == (8, 8)
    sess = QwenStreamSession(want, served.tokenizer, frame_hw=(56, 56),
                             clip_size=2, bank_size=1200)
    src = SyntheticSource(4, 56, 56, fps=1.0)
    for i in (0, 2):
        sess.ingest_frames([src[i], src[i + 1]])
    gen = tcli.GenerationConfig(max_new_tokens=4,
                                eos_token_ids=(sess.tokenizer.eos_token_id,))
    assert summary["answers"][0]["answer"] == sess.answer("Q?", gen)
    with pytest.raises(ValueError, match="--model-path"):
        tcli.main(["--device", "cpu"])


def _cast(tree):
    return {k: _cast(v) if isinstance(v, dict) else v.to(torch.bfloat16)
            for k, v in tree.items()}


def test_w8a8_flag_sets_the_switch():
    """--w8a8-prefill no longer raises: `_apply_quantization` turns the
    port's switch on, as the JAX server turns its own."""
    args = tcli.make_parser().parse_args(["--w8a8-prefill"])
    tlayers.W8A8_PREFILL = False
    assert tcli._apply_quantization({}, args) == {}
    assert tlayers.W8A8_PREFILL is True


def test_session_refuses_unported_options():
    """Both options this test once saw refused are ported (it keeps its
    name): --kv-int8 builds a session whose answers' cache is int8 with
    its two scale buffers (its ids are held to JAX's in
    test_dry_run_matches_jax_server and tests/test_torch_streaming.py), and
    a placement builds a disaggregated session whose int8 cache is one a
    decode shard (tests/test_torch_disaggregated_serve.py holds it to
    JAX's)."""
    from flash_vstream_tpu_torch.parallel.serve import make_serve_placement
    from flash_vstream_tpu_torch.runtime.streaming import QwenStreamSession
    sess = tcli.build_session(tcli.make_parser().parse_args(
        ["--dry-run", "--device", "cpu", "--kv-int8"]))
    cache = sess.generator.new_cache(1, 16)
    assert cache.k.dtype == cache.v.dtype == torch.int8 and cache.quantized
    assert cache.k_scale.shape == cache.k.shape[:-1] + (1,)
    assert cache.k_scale.data_ptr() != cache.v_scale.data_ptr()
    assert tcli.build_session(tcli.make_parser().parse_args(
        ["--dry-run", "--device", "cpu"])).generator.cache_dtype \
        == torch.bfloat16
    placed = QwenStreamSession(
        sess.model, sess.tokenizer, kv_cache_dtype=torch.int8,
        placement=make_serve_placement(1, 2, ["cpu"] * 3))
    cache = placed.generator.new_cache(1, 16)
    assert [c.k.dtype for c in cache.shards] == [torch.int8] * 2
    assert all(c.quantized for c in cache.shards)


# ---------------------------------------------------------------------------
# the LLaVA family
# ---------------------------------------------------------------------------

LLAVA = ["--model-family", "llava", "--dry-run", "--synthetic-frames", "8",
         "--clip-size", "2", "--fps", "2", "--play_speed", "0",
         "--question", "What is happening?", "--max-new-tokens", "6"]


def _run_both_llava(monkeypatch, argv):
    """Both servers over argv on the JAX tiny LLaVA tree and the JAX
    session's draws (PRNGKey(step)): (JAX summary, port summary, JAX
    greedy ids, port ids)."""
    from flash_vstream_tpu.core.config import tiny_llava_config as jtiny
    from flash_vstream_tpu.models.vstream_llava import init_llava_params
    jparams = init_llava_params(jax.random.PRNGKey(0), jtiny())
    jids, tids = [], []

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
        sess._uniforms = _jax_draws
        tokens = sess.answer_tokens

        def record(*a, **k):
            out = tokens(*a, **k)
            tids.append(list(out))
            return out
        sess.answer_tokens = record
        return sess
    monkeypatch.setattr(jcli, "build_session", jax_build)
    monkeypatch.setattr(tcli, "build_session", port_build)
    monkeypatch.setattr(
        "flash_vstream_tpu_torch.models.vstream_llava.init_llava_params",
        port_init)
    want = jcli.run_server(jcli.make_parser().parse_args(argv))
    got = tcli.run_server(tcli.make_parser().parse_args(
        argv + ["--device", "cpu"]))
    return want, got, jids, tids


@pytest.mark.parametrize("flags", [
    ["--question_interval", "0.0001"],
    ["--prewarm", "--question_interval", "1000"],
    ["--load-4bit", "--question_interval", "0.0001"],
    ["--kv-int8", "--question_interval", "0.0001"],
], ids=["plain", "prewarm", "load_4bit", "kv_int8"])
def test_llava_dry_run_matches_jax_server(monkeypatch, flags):
    """--model-family llava --dry-run: the same frames ingested and every
    greedy answer JAX's ids and text (the answer after each clip and after
    the stream; with --prewarm the answers of the prewarm too)."""
    want, got, jids, tids = _run_both_llava(monkeypatch, LLAVA + flags)
    assert got["frames_ingested"] == want["frames_ingested"] == 8
    assert len(tids) == len(jids) >= len(got["answers"]) >= 1
    assert tids == jids
    assert [a["answer"] for a in got["answers"]] == [
        a["answer"] for a in want["answers"]]
    assert [a["frames"] for a in got["answers"]] == [
        a["frames"] for a in want["answers"]]
    for name in ("memory_latency", "llm_latency", "conv_latency",
                 "memory_latency_dispatch", "memory_latency_host_preprocess"):
        assert name in got["metrics"] and name in want["metrics"], name


def test_llava_flags_build_the_session():
    """--load-4bit / --load-8bit quantize the Vicuna decoder, --kv-int8
    gives the answers an int8 cache; the CLIP tower stays as it is."""
    from flash_vstream_tpu_torch.runtime.streaming import LLaVAStreamSession
    base = ["--model-family", "llava", "--dry-run", "--device", "cpu"]
    sess = tcli.build_session(tcli.make_parser().parse_args(
        base + ["--load-4bit", "--kv-int8", "--clip-size", "3"]))
    assert isinstance(sess, LLaVAStreamSession) and sess.clip_size == 3
    llm = sess.generator.llm.tree()
    assert isinstance(llm["layers"]["mlp"]["up"]["w"], QuantWeight4)
    assert isinstance(sess.params["vit"]["layers"]["attn"]["wq"]["w"],
                      torch.Tensor)
    assert sess.generator.cache_dtype == torch.int8
    sess = tcli.build_session(tcli.make_parser().parse_args(
        base + ["--load-8bit"]))
    assert isinstance(sess.generator.llm.tree()["layers"]["attn"]["wq"]["w"],
                      QuantWeight)
    assert sess.generator.cache_dtype == torch.bfloat16


def test_llava_model_path_serves_the_checkpoint(monkeypatch, tmp_path):
    """--model-family llava --model-path DIR on a tiny LLaVA checkpoint the
    port wrote (an HF Llama-style tokenizer beside it): the port's server
    loads it in bf16 and answers JAX's server's ids and text on the same
    directory (both given the tiny config, where they take the full one)."""
    from torch_ckpt import write_tiny_llava_checkpoint
    import flash_vstream_tpu.core.config as jconfig
    from flash_vstream_tpu_torch.core.config import tiny_llava_config
    ckpt = str(tmp_path / "llava")
    cfg, params = write_tiny_llava_checkpoint(ckpt)
    jtiny = jconfig.tiny_llava_config()
    monkeypatch.setattr(jconfig, "VStreamLLaVAConfig", lambda: jtiny)
    monkeypatch.setattr("flash_vstream_tpu_torch.runtime.pipeline."
                        "VStreamLLaVAConfig", tiny_llava_config)
    argv = ["--model-family", "llava", "--model-path", ckpt,
            "--frame-size", "112", "--synthetic-frames", "6",
            "--clip-size", "2", "--play_speed", "0", "--question", "Q?",
            "--question_interval", "1000", "--max-new-tokens", "5"]
    jids, tids = [], []

    def jax_build(args, build=jcli.build_session):
        sess = build(args)
        fused = sess._answer_fused
        sess._answer_fused = lambda *a, **k: jids.append(
            [int(t) for t in fused(*a, **k)]) or jids[-1]
        return sess

    def port_build(args, build=tcli.build_session):
        sess = build(args)
        sess._uniforms = _jax_draws
        tokens = sess.answer_tokens
        sess.answer_tokens = lambda *a, **k: tids.append(
            list(tokens(*a, **k))) or tids[-1]
        return sess
    monkeypatch.setattr(jcli, "build_session", jax_build)
    monkeypatch.setattr(tcli, "build_session", port_build)
    want = jcli.run_server(jcli.make_parser().parse_args(argv))
    got = tcli.run_server(tcli.make_parser().parse_args(
        argv + ["--device", "cpu"]))
    assert got["frames_ingested"] == want["frames_ingested"] == 6
    assert tids == jids and len(tids) == 1
    assert got["answers"][0]["answer"] == want["answers"][0]["answer"]
    served = tcli.build_session(tcli.make_parser().parse_args(
        argv + ["--device", "cpu"]))
    assert served.tokenizer.eos_token_id == 2
    assert served.params["llm"]["embed"].dtype == torch.bfloat16
    assert torch.equal(served.params["vit"]["pos_embed"],
                       params["vit"]["pos_embed"].to(torch.bfloat16))


@pytest.mark.parametrize("family", ["qwen", "llava"])
def test_threaded_ingest_matches_jax_server(monkeypatch, family):
    """--threaded-ingest: a pacing thread ingests every frame while the
    caller's thread waits to answer; the answer after the stream is JAX's
    (ids and text), and the summary counts missed_clip_deadlines, as
    JAX's does."""
    flags = ["--threaded-ingest", "--question_interval", "1000"]
    if family == "qwen":
        want, got, jids, tids, _ = _run_both(monkeypatch, flags)
    else:
        want, got, jids, tids = _run_both_llava(monkeypatch, LLAVA + flags)
    assert got["frames_ingested"] == want["frames_ingested"] == 8
    assert len(got["answers"]) == len(want["answers"]) == 1
    assert tids == jids and len(tids) == 1
    assert got["answers"][0]["answer"] == want["answers"][0]["answer"]
    assert got["metrics"]["missed_clip_deadlines"]["val"] == 0
    assert "missed_clip_deadlines" in want["metrics"]
