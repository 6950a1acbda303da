"""The port's HTTP server (serve/http_server.py) against a live
ThreadingHTTPServer on the tiny --dry-run model with --device cpu: the Qwen
cases of tests/test_http_server.py (create a stream, POST npy and JPEG
frames, answer plain and as SSE, metrics, delete, errors, streams sharing
the model and Generator, the prewarmed template, an answer before any
frames), and the answers held to the sessions' own: an HTTP answer is the
session's answer on the same frames, the SSE deltas join into it, and the
generation settings a client sends reach the decode (a preemptible answer
equals the greedy one, a sampled one repeats with its seed)."""
import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from flash_vstream_tpu_torch.runtime.generation import GenerationConfig
from flash_vstream_tpu_torch.serve import http_server as ths
from flash_vstream_tpu_torch.serve.cli_server import build_session, make_parser

torch.set_num_threads(1)
DRY = ["--dry-run", "--device", "cpu", "--clip-size", "2",
       "--max-new-tokens", "4"]


def _req(url, method="GET", data=None, content_type="application/json"):
    if isinstance(data, dict):
        data = json.dumps(data).encode()
    r = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        r.add_header("Content-Type", content_type)
    try:
        with urllib.request.urlopen(r, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _sse(url, body):
    """(deltas, saw [DONE]) of one streamed answer."""
    r = urllib.request.Request(url, method="POST",
                               data=json.dumps(body).encode())
    r.add_header("Content-Type", "application/json")
    deltas, done = [], False
    with urllib.request.urlopen(r, timeout=120) as resp:
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        for line in resp:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":
                done = True
                break
            deltas.append(json.loads(payload)["delta"])
    return deltas, done


@pytest.fixture(scope="module")
def server():
    args = make_parser().parse_args(DRY)
    httpd = ths.serve_http(lambda: build_session(args), port=0,
                           preempt_chunk=2, prefill_chunk=16)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", httpd
    httpd.shutdown()
    httpd.server_close()


def _frames(n, h=64, w=64, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, size=(n, h, w, 3), dtype=np.uint8)


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def test_http_end_to_end(server):
    base, httpd = server
    code, health = _req(f"{base}/healthz")
    assert code == 200 and health["ok"]
    code, out = _req(f"{base}/v1/streams", "POST", {"id": "s1"})
    assert code == 201 and out["id"] == "s1"
    # a batch of 4 npy frames: 2 whole clips ingest, nothing buffered
    frames = _frames(4)
    code, out = _req(f"{base}/v1/streams/s1/frames", "POST", _npy(frames),
                     content_type="application/octet-stream")
    assert code == 200 and out["frames_total"] == 4 and out["buffered"] == 0
    # one JPEG buffers (clip_size 2)
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.zeros((64, 64, 3), np.uint8)).save(buf, format="JPEG")
    code, out = _req(f"{base}/v1/streams/s1/frames", "POST", buf.getvalue(),
                     content_type="image/jpeg")
    assert code == 200 and out["buffered"] == 1
    # the answer flushes the buffered frame, then decodes
    code, out = _req(f"{base}/v1/streams/s1/answer", "POST",
                     {"question": "What is happening?", "max_new_tokens": 4})
    assert code == 200 and isinstance(out["answer"], str)
    # the same frames through a session of its own give the same answer
    solo = build_session(make_parser().parse_args(DRY))
    solo.ingest_frames(list(frames[:2]))
    solo.ingest_frames(list(frames[2:]))
    jpeg = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    solo.ingest_frames([jpeg])
    gen = GenerationConfig(max_new_tokens=4,
                           eos_token_ids=(solo.tokenizer.eos_token_id,))
    assert out["answer"] == solo.answer("What is happening?", gen)
    code, out = _req(f"{base}/v1/streams/s1/metrics")
    assert code == 200 and out["frames_received"] == 5
    assert out["frames_buffered"] == 0
    assert "memory_latency_dispatch" in out["metrics"]
    assert httpd.registry.get("s1").session.n_frames == 3
    code, out = _req(f"{base}/v1/streams/s1", "DELETE")
    assert code == 200 and out["deleted"] == "s1"
    code, _ = _req(f"{base}/v1/streams/s1/metrics")
    assert code == 404


def test_http_sse_streaming_answer(server):
    base, _ = server
    code, _ = _req(f"{base}/v1/streams", "POST", {"id": "sse"})
    assert code == 201
    code, _ = _req(f"{base}/v1/streams/sse/frames?flush=1", "POST",
                   _npy(_frames(3, seed=1)),
                   content_type="application/octet-stream")
    assert code == 200
    body = {"question": "Q?", "max_new_tokens": 8}
    deltas, done = _sse(f"{base}/v1/streams/sse/answer",
                        dict(body, stream=True))
    assert done and all(isinstance(d, str) for d in deltas)
    code, out = _req(f"{base}/v1/streams/sse/answer", "POST", body)
    assert code == 200 and "".join(deltas) == out["answer"]


def test_http_generation_settings(server):
    """A client's settings reach the decode: preemptible chunks (the
    server's sizes) answer as greedy, a seeded sample repeats, and
    speculation is exact."""
    base, httpd = server
    code, _ = _req(f"{base}/v1/streams", "POST", {"id": "gen"})
    code, _ = _req(f"{base}/v1/streams/gen/frames", "POST",
                   _npy(_frames(6, seed=2)),
                   content_type="application/octet-stream")
    url = f"{base}/v1/streams/gen/answer"
    q = {"question": "What?", "max_new_tokens": 6}
    answers = [_req(url, "POST", dict(q, **kw))[1]["answer"] for kw in (
        {}, {"preemptible_chunk": 1}, {"speculative_k": 3},
        {"temperature": 0.8, "top_k": 50, "top_p": 0.9},
        {"temperature": 0.8, "top_k": 50, "top_p": 0.9})]
    assert answers[0] == answers[1] == answers[2]
    assert answers[3] == answers[4]
    sess = httpd.registry.get("gen").session
    seen = []
    generate = sess.generator.generate

    def spy(embeds, positions, gen, **kw):
        seen.append(gen)
        return generate(embeds, positions, gen, **kw)
    sess.generator.generate = spy
    try:
        _req(url, "POST", dict(q, preemptible_chunk=5, stop_strings=["x"],
                               eos_token_ids=[1, 2]))
    finally:
        del sess.generator.generate
    assert (seen[0].preemptible_chunk, seen[0].prefill_chunk) == (2, 16)
    assert seen[0].stop_strings == ("x",) and seen[0].eos_token_ids == (1, 2)


def test_http_errors(server):
    base, _ = server
    code, _ = _req(f"{base}/v1/streams/missing/answer", "POST",
                   {"question": "?"})
    assert code == 404
    code, _ = _req(f"{base}/nothing")
    assert code == 404
    code, _ = _req(f"{base}/v1/streams", "POST", {"id": "dup"})
    assert code == 201
    code, out = _req(f"{base}/v1/streams", "POST", {"id": "dup"})
    assert code == 409 and "exists" in out["error"]
    code, _ = _req(f"{base}/v1/streams/dup/frames", "POST", b"not an npy",
                   content_type="application/octet-stream")
    assert code == 400
    code, out = _req(f"{base}/v1/streams/dup/frames", "POST",
                     _npy(np.zeros((8, 8, 3), np.float32)),
                     content_type="application/octet-stream")
    assert code == 400 and "uint8" in out["error"]
    code, _ = _req(f"{base}/v1/streams/dup/frames", "POST",
                   _npy(_frames(2, seed=3)),
                   content_type="application/octet-stream")
    assert code == 200
    for bad in ({"max_new_tokens": -1}, {"top_k": 1.5},
                {"speculative_k": True}, {"temperature": "hot"},
                {"eos_token_ids": [1, "a"]}, {"stop_strings": "x"}):
        code, out = _req(f"{base}/v1/streams/dup/answer", "POST",
                         dict(bad, question="?"))
        assert code == 400, bad
    code, _ = _req(f"{base}/v1/streams/dup", "DELETE")
    code, _ = _req(f"{base}/v1/streams/dup", "DELETE")
    assert code == 404


def test_http_answer_before_frames_is_400(server):
    base, _ = server
    code, _ = _req(f"{base}/v1/streams", "POST", {"id": "empty"})
    assert code == 201
    code, out = _req(f"{base}/v1/streams/empty/answer", "POST",
                     {"question": "Q?"})
    assert code == 400 and "no frames" in out["error"]


def test_http_streams_share_the_model_and_generator():
    """Stream N + 1 clones the first session: the same model, Generator
    and tokenizer, a memory of its own."""
    args = make_parser().parse_args(DRY)
    httpd = ths.serve_http(lambda: build_session(args), port=0,
                           max_streams=2)
    try:
        reg = httpd.registry
        a, b = reg.create("a"), reg.create("b")
        sa, sb = reg.get(a).session, reg.get(b).session
        assert sa is not sb and sa.model is sb.model
        assert sa.generator is sb.generator and sa.tokenizer is sb.tokenizer
        assert sa.state.bank.data_ptr() != sb.state.bank.data_ptr()
        reg.get(a).add_frames(list(_frames(2)))
        assert sa.n_frames == 1 and sb.n_frames == 0
        with pytest.raises(RuntimeError, match="max_streams"):
            reg.create("c")
    finally:
        httpd.server_close()


def test_http_prewarm_template():
    """--prewarm answers in every bucket on the template session before
    traffic (then resets it); every stream is a clone of the template."""
    httpd = ths.make_server(DRY + ["--port", "0", "--prewarm"])
    try:
        reg = httpd.registry
        tmpl = reg._template
        assert tmpl is not None and tmpl._published == (None, 0)
        assert tmpl.metrics.get("answer_tokens") is None     # reset after
        for sid in ("first", "second"):
            sess = reg.get(reg.create(sid)).session
            assert sess is not tmpl and sess.generator is tmpl.generator
            assert sess.model is tmpl.model and sess._published == (None, 0)
    finally:
        httpd.server_close()


def test_http_main_runs_on_the_card_by_default():
    """Without --device the server is for the card: with no card it raises
    before it serves."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device"):
        ths.make_server(["--dry-run", "--port", "0"])


def test_http_concurrent_frame_posts(server):
    """16 client threads post frames to one stream at once (a short switch
    interval): no frame is lost and every whole clip is ingested once."""
    import sys
    base, httpd = server
    _req(f"{base}/v1/streams", "POST", {"id": "busy"})
    body = _npy(_frames(1, seed=4))
    errors = []

    def post():
        try:
            for _ in range(3):
                code, _ = _req(f"{base}/v1/streams/busy/frames", "POST", body,
                               content_type="application/octet-stream")
                assert code == 200
        except Exception as e:                  # reported below
            errors.append(e)
    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=post) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(was)
    assert not errors and not any(t.is_alive() for t in threads)
    st = httpd.registry.get("busy")
    assert st.n_frames_received == 48 and not st.buf
    assert st.session.n_frames == 24
