"""HTTP serving API for streaming video QA, standard library only.

Port of flash_vstream_tpu/serve/http_server.py, route for route:

    POST   /v1/streams                      {"id"?: str} -> {"id": str}
    POST   /v1/streams/<id>/frames[?flush=1] body = JPEG bytes
                                            (Content-Type: image/*) or a
                                            .npy uint8 [H,W,3] / [N,H,W,3]
                                            array; frames buffer host-side
                                            and ingest on clip boundaries
    POST   /v1/streams/<id>/answer          {"question": str,
                                             "max_new_tokens"?: int,
                                             "temperature"?, "top_k"?,
                                             "top_p"?, "eos_token_ids"?,
                                             "stop_strings"?,
                                             "speculative_k"?,
                                             "preemptible_chunk"?,
                                             "stream"?: bool}
                                            -> {"answer": str} or, with
                                            stream=true, text/event-stream
                                            deltas ending in data: [DONE]
    GET    /v1/streams/<id>/metrics         -> MetricMeter snapshot + frames
    DELETE /v1/streams/<id>                 -> {"deleted": id}
    GET    /healthz                         -> {"ok": true, "streams": n}

The first stream gets the session the factory builds (the template); each
later one a `clone_fresh` of it, which shares the model and the Generator
and has its own memory. A stream's frames and its ingests are ordered by
its lock; an answer reads the published (snapshot, count) pair, so frame
and answer requests on different connections may overlap. The handlers run
on threads of their own, and every decode entry point they reach runs under
`torch.no_grad`. Clients only toggle preemption: the chunk sizes are the
server's (--preempt, --prefill-chunk).

    python -m flash_vstream_tpu_torch.serve.http_server --dry-run --device cpu
    python -m flash_vstream_tpu_torch.serve.http_server --dry-run --port 8080

(every flag of the CLI server's parser, plus --host, --port, --max-streams;
with no --device the server runs on the card and raises without one).
"""
from __future__ import annotations

import io
import json
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np


class _Stream:
    """One live stream: a session plus a host-side partial-clip buffer."""

    def __init__(self, session):
        self.session = session
        self.buf: List[np.ndarray] = []
        self.lock = threading.Lock()          # guards buf and ingest order
        self.n_frames_received = 0

    def add_frames(self, frames: List[np.ndarray], flush: bool = False):
        with self.lock:
            self.buf.extend(frames)
            self.n_frames_received += len(frames)
            clip = self.session.clip_size
            while len(self.buf) >= clip:
                self.session.ingest_frames(self.buf[:clip])
                self.buf = self.buf[clip:]
            if flush and self.buf:
                self.session.ingest_frames(self.buf)   # padded partial clip
                self.buf = []


class StreamServer:
    """Registry of live streams over one shared model."""

    def __init__(self, session_factory, max_streams: int = 64,
                 preempt_chunk: int = 0, prefill_chunk: int = 0):
        self._factory = session_factory
        self._streams: Dict[str, _Stream] = {}
        self._lock = threading.Lock()
        self._max = max_streams
        # the only chunk sizes preemptible answers use (JAX: each size is a
        # compile; here they are the server's policy all the same)
        self.preempt_chunk = int(preempt_chunk)
        self.prefill_chunk = int(prefill_chunk)
        self._template = None      # the first session; later ones clone it

    def _new_session(self):
        if self._template is None:
            self._template = self._factory()
            return self._template
        return self._template.clone_fresh()

    def create(self, stream_id: Optional[str] = None) -> str:
        sid = stream_id or uuid.uuid4().hex[:12]
        with self._lock:
            if sid in self._streams:
                raise KeyError(f"stream {sid!r} already exists")
            if len(self._streams) >= self._max:
                raise RuntimeError(f"max_streams={self._max} reached")
            self._streams[sid] = _Stream(self._new_session())
        return sid

    def get(self, sid: str) -> _Stream:
        with self._lock:
            if sid not in self._streams:
                raise KeyError(f"unknown stream {sid!r}")
            return self._streams[sid]

    def delete(self, sid: str):
        with self._lock:
            if sid not in self._streams:
                raise KeyError(f"unknown stream {sid!r}")
            del self._streams[sid]

    def __len__(self):
        with self._lock:
            return len(self._streams)


def _decode_body(body: bytes, content_type: str) -> List[np.ndarray]:
    """JPEG bytes (PIL, imported for image bodies only) or a serialized
    .npy ([H,W,3] or [N,H,W,3] uint8) -> frames."""
    if content_type.startswith("image/"):
        from PIL import Image
        return [np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))]
    arr = np.load(io.BytesIO(body), allow_pickle=False)
    if arr.dtype != np.uint8 or arr.ndim not in (3, 4) or arr.shape[-1] != 3:
        raise ValueError(
            f"expected uint8 [H,W,3] or [N,H,W,3], got {arr.dtype} "
            f"{arr.shape}")
    return [arr] if arr.ndim == 3 else list(arr)


def make_handler(server: StreamServer):
    from ..runtime.generation import GenerationConfig

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):     # quiet
            pass

        # -- helpers -----------------------------------------------------
        def _json(self, code: int, obj: dict):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n) if n else b""

        def _route(self):
            return [p for p in self.path.split("?")[0].split("/") if p]

        def _query(self) -> dict:
            from urllib.parse import parse_qs, urlsplit
            return parse_qs(urlsplit(self.path).query)

        def _gen(self, req: dict, session) -> Optional[GenerationConfig]:
            """The client's GenerationConfig (None: the session's default).
            A value of the wrong type raises ValueError, answered 400."""
            keys = ("max_new_tokens", "temperature", "top_k", "top_p",
                    "eos_token_ids", "stop_strings", "speculative_k",
                    "preemptible_chunk")
            kw = {k: req[k] for k in keys if k in req}
            if not kw:
                return None
            for k in ("max_new_tokens", "top_k", "speculative_k",
                      "preemptible_chunk"):
                if k in kw:
                    if not isinstance(kw[k], int) or isinstance(kw[k], bool) \
                            or kw[k] < 0:
                        raise ValueError(
                            f"{k} must be a non-negative integer, "
                            f"got {kw[k]!r}")
            for k in ("temperature", "top_p"):
                if k in kw:
                    if not isinstance(kw[k], (int, float)) \
                            or isinstance(kw[k], bool):
                        raise ValueError(f"{k} must be a number, "
                                         f"got {kw[k]!r}")
                    kw[k] = float(kw[k])
            if kw.get("preemptible_chunk"):
                kw["preemptible_chunk"] = server.preempt_chunk
                if server.prefill_chunk:
                    kw["prefill_chunk"] = server.prefill_chunk
            if "eos_token_ids" in kw:
                if not isinstance(kw["eos_token_ids"], list) or not all(
                        isinstance(t, int) for t in kw["eos_token_ids"]):
                    raise ValueError("eos_token_ids must be a list of ints")
            if "stop_strings" in kw:
                if not isinstance(kw["stop_strings"], list) or not all(
                        isinstance(s, str) for s in kw["stop_strings"]):
                    raise ValueError("stop_strings must be a list of strings")
                kw["stop_strings"] = tuple(kw["stop_strings"])
            kw.setdefault("eos_token_ids",
                          (session.tokenizer.eos_token_id,))
            kw["eos_token_ids"] = tuple(kw["eos_token_ids"])
            return GenerationConfig(**kw)

        # -- methods -----------------------------------------------------
        def do_GET(self):
            try:
                parts = self._route()
                if parts == ["healthz"]:
                    return self._json(200, {"ok": True,
                                            "streams": len(server)})
                if (len(parts) == 4 and parts[:2] == ["v1", "streams"]
                        and parts[3] == "metrics"):
                    st = server.get(parts[2])
                    return self._json(200, {
                        "frames_received": st.n_frames_received,
                        "frames_buffered": len(st.buf),
                        "metrics": st.session.metrics.as_dict()})
                self._json(404, {"error": f"no route {self.path}"})
            except KeyError as e:
                self._json(404, {"error": str(e)})
            except Exception as e:                     # pragma: no cover
                self._json(500, {"error": repr(e)})

        def do_DELETE(self):
            try:
                parts = self._route()
                if len(parts) == 3 and parts[:2] == ["v1", "streams"]:
                    server.delete(parts[2])
                    return self._json(200, {"deleted": parts[2]})
                self._json(404, {"error": f"no route {self.path}"})
            except KeyError as e:
                self._json(404, {"error": str(e)})

        def do_POST(self):
            try:
                parts = self._route()
                if parts == ["v1", "streams"]:
                    req = json.loads(self._body() or b"{}")
                    try:
                        sid = server.create(req.get("id"))
                    except KeyError as e:
                        return self._json(409, {"error": str(e)})
                    return self._json(201, {"id": sid})
                if (len(parts) == 4 and parts[:2] == ["v1", "streams"]
                        and parts[3] == "frames"):
                    st = server.get(parts[2])
                    frames = _decode_body(
                        self._body(),
                        self.headers.get("Content-Type",
                                         "application/octet-stream"))
                    flush = self._query().get("flush", ["0"])[0] not in (
                        "0", "false", "")
                    st.add_frames(frames, flush=flush)
                    return self._json(200, {
                        "received": len(frames),
                        "frames_total": st.n_frames_received,
                        "buffered": len(st.buf)})
                if (len(parts) == 4 and parts[:2] == ["v1", "streams"]
                        and parts[3] == "answer"):
                    st = server.get(parts[2])
                    req = json.loads(self._body() or b"{}")
                    question = req["question"]
                    # buffered tail frames are part of what is answered
                    st.add_frames([], flush=True)
                    if st.session._published[0] is None:
                        return self._json(400, {
                            "error": "no frames ingested on this stream yet"})
                    gen = self._gen(req, st.session)
                    if req.get("stream"):
                        return self._sse_answer(st, question, gen)
                    answer = st.session.answer(question, gen)
                    return self._json(200, {"answer": answer})
                self._json(404, {"error": f"no route {self.path}"})
            except KeyError as e:
                self._json(404, {"error": str(e)})
            except (ValueError, AssertionError) as e:
                self._json(400, {"error": str(e)})
            except Exception as e:                     # pragma: no cover
                self._json(500, {"error": repr(e)})

        def _sse_answer(self, st: _Stream, question: str, gen):
            """Server-sent events: one JSON text delta an event, then
            `data: [DONE]`."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            # SSE has no length; closing the connection ends the stream
            self.send_header("Connection", "close")
            self.end_headers()
            for delta in st.session.answer_stream(question, gen):
                payload = json.dumps({"delta": delta})
                self.wfile.write(f"data: {payload}\n\n".encode())
                self.wfile.flush()
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
            self.close_connection = True

    return Handler


def serve_http(session_factory, host: str = "127.0.0.1", port: int = 8080,
               max_streams: int = 64, preempt_chunk: int = 0,
               prefill_chunk: int = 0) -> ThreadingHTTPServer:
    """Start the HTTP server and return it: call .serve_forever(), or run
    that in a thread and .shutdown() to stop. Port 0 takes a free port
    (`server_address[1]`)."""
    registry = StreamServer(session_factory, max_streams=max_streams,
                            preempt_chunk=preempt_chunk,
                            prefill_chunk=prefill_chunk)
    httpd = ThreadingHTTPServer((host, port), make_handler(registry))
    httpd.registry = registry
    return httpd


def make_parser():
    """The CLI server's parser (model, quantization, --device, --preempt,
    --prefill-chunk, --prewarm) with --host, --port and --max-streams."""
    from .cli_server import make_parser as cli_parser
    p = cli_parser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-streams", type=int, default=64)
    return p


def make_server(argv=None) -> ThreadingHTTPServer:
    """The server the command line asks for, not yet serving. With no card
    and no --device cpu it raises before it builds anything; with
    --prewarm the template session answers once in every memory bucket
    (then resets), and every stream clones it."""
    from ..core.device import resolve_device
    from ..runtime.generation import GenerationConfig
    from ..utils.logging import build_logger
    from .cli_server import _check_ported, build_session, prewarm_session
    args = make_parser().parse_args(argv)
    _check_ported(args)
    resolve_device(args.device)
    httpd = serve_http(lambda: build_session(args), host=args.host,
                       port=args.port, max_streams=args.max_streams,
                       preempt_chunk=args.preempt,
                       prefill_chunk=args.prefill_chunk)
    if args.prewarm:
        sess = httpd.registry._new_session()
        prewarm_session(
            sess, args,
            GenerationConfig(max_new_tokens=args.max_new_tokens,
                             eos_token_ids=(sess.tokenizer.eos_token_id,)),
            build_logger("http_server"))
    return httpd


def main(argv=None):
    httpd = make_server(argv)
    host, port = httpd.server_address[:2]
    print(f"serving on http://{host}:{port}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
