"""OpenAI-compatible HTTP serving front-end over :class:`ServingEngine`.

Counterpart of :mod:`lamp_tpu.models.openai_api` (a copy): a
self-contained HTTP server (stdlib ``http.server``, no web-framework
dependency) speaking the OpenAI REST dialect, multiplexing any number of
concurrent clients onto ONE continuous-batching engine, so that the card
decodes a full batch.

Endpoints:

- ``POST /v1/completions``: prompt in, text out; ``stream=true`` for
  server-sent events; ``n``/``best_of`` parallel sampling; ``stop``
  strings; per-request ``temperature/top_p/top_k/min_p/max_tokens/
  presence_penalty/frequency_penalty/repetition_penalty/logprobs``
  through :class:`~lamp_tpu_torch.models.sampling.SamplingParams`.
- ``POST /v1/chat/completions``: messages rendered through a chat
  template (pluggable callable), same controls.
- ``GET /v1/models``, ``GET /health``, ``GET /metrics``.

Architecture: HTTP handler threads never touch the device. They tokenize,
submit under the engine lock, and block on a per-request queue. A single
background thread owns the engine and loops ``engine.step()`` while work
exists; each step decodes a chunk for every live client, so concurrent
requests batch automatically (continuous batching). The engine hands each
accepted token to ``on_token`` as a host ``int`` (the server reads the
sampled tokens to the host once a step), and only host ints and floats go
through the queues to the handler threads. Client disconnects and
stop-string hits call :meth:`ServingEngine.cancel`, freeing KV pages
mid-flight.

Incremental detokenization holds back trailing bytes that do not yet
decode to complete UTF-8 (multi-byte codepoints split across BPE tokens),
and holds back ``len(longest stop string) - 1`` characters so a stop
string is never partially emitted.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .sampling import SamplingParams

__all__ = ["OpenAIFrontend", "OpenAIHTTPServer", "default_chat_template",
           "APIError"]


class APIError(Exception):
    """Maps to an OpenAI-style error JSON with an HTTP status."""

    def __init__(self, message: str, status: int = 400,
                 err_type: str = "invalid_request_error"):
        super().__init__(message)
        self.status = status
        self.err_type = err_type

    def to_json(self) -> Dict:
        return {"error": {"message": str(self), "type": self.err_type,
                          "param": None, "code": None}}


def default_chat_template(messages: Sequence[Dict]) -> str:
    """Minimal ChatML-ish rendering; swap in a model-specific template via
    ``OpenAIFrontend(chat_template=...)`` for instruction-tuned weights."""
    parts = []
    for m in messages:
        role = m.get("role", "user")
        content = m.get("content", "")
        if not isinstance(content, str):
            raise APIError("message content must be a string")
        parts.append(f"<|{role}|>\n{content}\n")
    parts.append("<|assistant|>\n")
    return "".join(parts)


def _encode(tokenizer, text: str) -> List[int]:
    try:
        ids = tokenizer.encode(text)
    except TypeError:
        ids = tokenizer.encode(text.encode("utf-8"))
    return [int(t) for t in np.asarray(ids).reshape(-1)]


def _decode(tokenizer, ids: Sequence[int]) -> str:
    out = tokenizer.decode(list(ids))
    if isinstance(out, bytes):
        return out.decode("utf-8", "replace")
    return out


def _as_str_list(v, name) -> List[str]:
    if v is None:
        return []
    if isinstance(v, str):
        return [v]
    if isinstance(v, list) and all(isinstance(s, str) for s in v):
        return v
    raise APIError(f"{name} must be a string or list of strings")


class OpenAIFrontend:
    """Protocol layer: request dicts in, response dicts / SSE chunks out.

    Owns the engine lock and the background step loop; usable directly
    (no HTTP) or wrapped by :class:`OpenAIHTTPServer`. ``tokenizer`` is
    anything with ``encode``/``decode`` (:class:`~lamp_tpu_torch.data.
    hf_tokenizer.HFTokenizer`, a byte-BPE :class:`~lamp_tpu_torch.data.
    tokenizer.Codec`, ...). ``eos_id`` terminates every request (on top
    of per-request ``stop`` strings)."""

    def __init__(self, engine, tokenizer, *, model_name: str = "lamp-tpu",
                 eos_id: Optional[int] = None,
                 chat_template: Callable[[Sequence[Dict]], str] = None,
                 default_max_tokens: int = 16):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.eos_id = eos_id
        self.chat_template = chat_template or default_chat_template
        self.default_max_tokens = default_max_tokens
        self._cv = threading.Condition()
        self._streams: Dict = {}      # rid -> Queue of event tuples
        self._budgets: Dict = {}      # rid -> per-choice decode budget
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._requests_total = 0
        self._tokens_total = 0
        self._started = time.time()

    # ------------------------------------------------------------------
    # engine loop

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="lamp-serving-loop")
        self._thread.start()

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _on_token(self, rid, tok) -> None:
        # fires inside engine.step() — the loop thread already holds _cv
        self._tokens_total += 1
        parent, idx = (rid[0], rid[1]) if isinstance(rid, tuple) else (rid, 0)
        q = self._streams.get(parent)
        if q is not None:
            q.put(("tok", idx, int(tok)))

    def _loop(self) -> None:
        eng = self.engine
        prev_hook = eng.on_token
        eng.on_token = self._on_token
        try:
            while True:
                with self._cv:
                    while not self._stop and not (
                            eng.pending or eng.server.seq_pages):
                        self._cv.wait(timeout=0.25)
                    if self._stop:
                        return
                    try:
                        finished = eng.step()
                    except Exception as e:  # surface to every waiter
                        for q in self._streams.values():
                            q.put(("error", f"engine failure: {e!r}"))
                        self._streams.clear()
                        continue
                    for rid in finished:
                        q = self._streams.get(rid)
                        if q is not None:
                            q.put(("done", eng.results.get(rid),
                                   eng.result_logprobs.get(rid)))
        finally:
            eng.on_token = prev_hook

    # ------------------------------------------------------------------
    # request plumbing

    def _submit(self, prompt_ids: List[int], params: SamplingParams,
                n: int, best_of: Optional[int]):
        """Register a stream queue, submit under the lock, wake the loop."""
        rid = f"cmpl-{uuid.uuid4().hex[:24]}"
        q: queue.Queue = queue.Queue()
        ctx = self.engine.server.model.context_length
        budget = ctx - len(prompt_ids) + 1
        if params.max_tokens is not None:
            budget = min(budget, params.max_tokens)
        with self._cv:
            self._streams[rid] = q
            self._budgets[rid] = budget
            self._requests_total += 1
            try:
                self.engine.submit(prompt_ids, params, request_id=rid,
                                   n=n, best_of=best_of)
            except ValueError as e:
                self._streams.pop(rid)
                self._budgets.pop(rid)
                raise APIError(str(e))
            self._cv.notify_all()
        return rid, q

    def _cancel(self, rid) -> None:
        with self._cv:
            self.engine.cancel(rid)
            self.engine.results.pop(rid, None)
            self.engine.result_logprobs.pop(rid, None)
            self._streams.pop(rid, None)
            self._budgets.pop(rid, None)

    def _finish(self, rid) -> None:
        with self._cv:
            self.engine.results.pop(rid, None)
            self.engine.result_logprobs.pop(rid, None)
            self._streams.pop(rid, None)
            self._budgets.pop(rid, None)

    def _params_from(self, body: Dict) -> SamplingParams:
        def num(name, default, lo=None, hi=None):
            v = body.get(name, default)
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                raise APIError(f"{name} must be a number")
            if lo is not None and v < lo or hi is not None and v > hi:
                raise APIError(f"{name} out of range")
            return float(v)

        max_tokens = body.get("max_tokens", self.default_max_tokens)
        if max_tokens is not None and (
                not isinstance(max_tokens, int) or max_tokens < 1):
            raise APIError("max_tokens must be a positive integer")
        stop_tokens = (self.eos_id,) if self.eos_id is not None else ()
        try:
            return SamplingParams(
                temperature=num("temperature", 1.0, lo=0.0),
                top_p=num("top_p", 1.0),
                top_k=int(num("top_k", 0, lo=0)),
                min_p=num("min_p", 0.0),
                max_tokens=max_tokens,
                stop_tokens=stop_tokens,
                presence_penalty=num("presence_penalty", 0.0),
                frequency_penalty=num("frequency_penalty", 0.0),
                repetition_penalty=num("repetition_penalty", 1.0),
                logprobs=bool(body.get("logprobs")),
            )
        except ValueError as e:
            raise APIError(str(e))

    # ------------------------------------------------------------------
    # completions

    def completion(self, body: Dict) -> Dict:
        """Non-streaming ``/v1/completions``. Returns the response dict."""
        prompt = body.get("prompt")
        if not isinstance(prompt, str):
            raise APIError("prompt must be a string")
        stop = _as_str_list(body.get("stop"), "stop")
        params = self._params_from(body)
        n = body.get("n", 1)
        best_of = body.get("best_of")
        if not isinstance(n, int) or n < 1:
            raise APIError("n must be a positive integer")
        if best_of is not None and (not isinstance(best_of, int)
                                    or best_of < n):
            raise APIError("best_of must be an integer >= n")
        if (n > 1 or best_of) and params.temperature == 0.0:
            raise APIError("n/best_of > 1 requires temperature > 0")

        prompt_ids = _encode(self.tokenizer, prompt)
        rid, q = self._submit(prompt_ids, params, n, best_of)
        toks, lps = self._await(rid, q)
        branches = toks if n > 1 else [toks]
        lp_branches = (lps if n > 1 else [lps]) if lps is not None \
            else [None] * len(branches)

        choices = []
        total_completion = 0
        for i, branch in enumerate(branches):
            text = _decode(self.tokenizer, branch)
            finish = "length" if len(branch) >= self._budget_of(
                rid, len(prompt_ids), params) else "stop"
            text, cut = _apply_stop_strings(text, stop)
            if cut:
                finish = "stop"
            total_completion += len(branch)
            choice = {"index": i, "text": text, "finish_reason": finish}
            if params.logprobs and lp_branches[i] is not None:
                choice["logprobs"] = {
                    "token_logprobs": [round(float(v), 6)
                                       for v in lp_branches[i]],
                    "tokens": [_decode(self.tokenizer, [t])
                               for t in branch],
                }
            choices.append(choice)
        self._finish(rid)
        return {
            "id": rid,
            "object": "text_completion",
            "created": int(time.time()),
            "model": self.model_name,
            "choices": choices,
            "usage": {
                "prompt_tokens": len(prompt_ids),
                "completion_tokens": total_completion,
                "total_tokens": len(prompt_ids) + total_completion,
            },
        }

    def completion_stream(self, body: Dict):
        """Streaming ``/v1/completions``: returns an iterator of
        response-chunk dicts. Validation and submission happen HERE (not
        lazily in the generator) so a bad request raises before any SSE
        bytes go out."""
        prompt = body.get("prompt")
        if not isinstance(prompt, str):
            raise APIError("prompt must be a string")
        if body.get("n", 1) != 1 or body.get("best_of") not in (None, 1):
            raise APIError("stream=true supports only n=1 without best_of")
        stop = _as_str_list(body.get("stop"), "stop")
        params = self._params_from(body)
        prompt_ids = _encode(self.tokenizer, prompt)
        rid, q = self._submit(prompt_ids, params, 1, None)

        def chunk(text, finish=None):
            return {
                "id": rid, "object": "text_completion",
                "created": int(time.time()), "model": self.model_name,
                "choices": [{"index": 0, "text": text,
                             "finish_reason": finish}],
            }

        return self._stream_core(rid, q, len(prompt_ids), params, stop,
                                 chunk)

    # ------------------------------------------------------------------
    # chat

    def chat_completion(self, body: Dict) -> Dict:
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            raise APIError("messages must be a non-empty list")
        inner = dict(body)
        inner["prompt"] = self.chat_template(messages)
        resp = self.completion(inner)
        resp["object"] = "chat.completion"
        for c in resp["choices"]:
            lp = c.pop("logprobs", None)
            c["message"] = {"role": "assistant", "content": c.pop("text")}
            if lp is not None:
                c["logprobs"] = {"content": [
                    {"token": t, "logprob": v}
                    for t, v in zip(lp["tokens"], lp["token_logprobs"])]}
        return resp

    def chat_completion_stream(self, body: Dict):
        """Streaming chat variant; eager validation like
        :meth:`completion_stream`."""
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            raise APIError("messages must be a non-empty list")
        if body.get("n", 1) != 1:
            raise APIError("stream=true supports only n=1")
        stop = _as_str_list(body.get("stop"), "stop")
        params = self._params_from(body)
        prompt_ids = _encode(self.tokenizer, self.chat_template(messages))
        rid, q = self._submit(prompt_ids, params, 1, None)
        first = [True]

        def chunk(text, finish=None):
            delta = {}
            if first[0]:
                delta["role"] = "assistant"
                first[0] = False
            if text:
                delta["content"] = text
            return {
                "id": rid, "object": "chat.completion.chunk",
                "created": int(time.time()), "model": self.model_name,
                "choices": [{"index": 0, "delta": delta,
                             "finish_reason": finish}],
            }

        return self._stream_core(rid, q, len(prompt_ids), params, stop,
                                 chunk)

    # ------------------------------------------------------------------
    # shared generation internals

    def _budget_of(self, rid, prompt_len: int,
                   params: SamplingParams) -> int:
        b = self._budgets.get(rid)
        if b is not None:
            return b
        ctx = self.engine.server.model.context_length
        cap = ctx - prompt_len + 1
        return min(cap, params.max_tokens) if params.max_tokens else cap

    def _await(self, rid, q):
        """Block until the request finishes; returns (tokens, logprobs)."""
        while True:
            kind, *rest = q.get()
            if kind == "done":
                return rest[0], rest[1]
            if kind == "error":
                self._finish(rid)
                raise APIError(rest[0], status=500, err_type="server_error")

    def _stream_core(self, rid, q, prompt_len, params, stop, make_chunk):
        """Incremental-decode loop shared by completion/chat streaming.

        Emits only text that can no longer change: trailing bytes that do
        not decode cleanly (U+FFFD from a split multi-byte codepoint) and
        the last ``len(longest stop) - 1`` chars are held back until more
        tokens arrive or the request ends."""
        budget = self._budget_of(rid, prompt_len, params)
        holdback = max((len(s) for s in stop), default=0)
        toks: List[int] = []
        emitted = 0
        try:
            while True:
                kind, *rest = q.get()
                if kind == "error":
                    raise APIError(rest[0], status=500,
                                   err_type="server_error")
                if kind == "tok":
                    toks.append(rest[1])
                    text = _decode(self.tokenizer, toks)
                    if text.endswith("�"):
                        continue
                    cut_text, hit = _apply_stop_strings(text, stop)
                    if hit:
                        if len(cut_text) > emitted:
                            yield make_chunk(cut_text[emitted:])
                        yield make_chunk("", finish="stop")
                        self._cancel(rid)
                        return
                    safe = len(text) - (holdback - 1 if holdback else 0)
                    if safe > emitted:
                        yield make_chunk(text[emitted:safe])
                        emitted = safe
                    continue
                # done
                final_toks = rest[0]
                text = _decode(self.tokenizer, final_toks)
                text, hit = _apply_stop_strings(text, stop)
                finish = "stop" if hit or len(final_toks) < budget \
                    else "length"
                if len(text) > emitted:
                    yield make_chunk(text[emitted:])
                yield make_chunk("", finish=finish)
                self._finish(rid)
                return
        except GeneratorExit:
            # client went away mid-stream — free its KV pages now
            self._cancel(rid)
            raise

    # ------------------------------------------------------------------

    def models_response(self) -> Dict:
        return {"object": "list", "data": [{
            "id": self.model_name, "object": "model",
            "created": int(time.time()), "owned_by": "lamp_tpu"}]}

    def metrics_text(self) -> str:
        """Prometheus text exposition: scheduler + KV-pool health."""
        with self._cv:
            eng = self.engine
            s = eng.server
            lines = [
                "# TYPE lamp_requests_total counter",
                f"lamp_requests_total {self._requests_total}",
                "# TYPE lamp_generated_tokens_total counter",
                f"lamp_generated_tokens_total {self._tokens_total}",
                "# TYPE lamp_requests_pending gauge",
                f"lamp_requests_pending {len(eng.pending)}",
                "# TYPE lamp_requests_running gauge",
                f"lamp_requests_running {len(s.seq_pages)}",
                "# TYPE lamp_kv_pages_free gauge",
                f"lamp_kv_pages_free {s.available_pages}",
                "# TYPE lamp_kv_pages_total gauge",
                f"lamp_kv_pages_total {s.total_pages}",
                "# TYPE lamp_uptime_seconds gauge",
                f"lamp_uptime_seconds {time.time() - self._started:.1f}",
            ]
        return "\n".join(lines) + "\n"


def _apply_stop_strings(text: str, stop: List[str]):
    """Cut ``text`` at the earliest stop-string occurrence (the stop string
    itself is not included, OpenAI semantics). Returns (text, hit?)."""
    best = None
    for s in stop:
        if s:
            i = text.find(s)
            if i >= 0 and (best is None or i < best):
                best = i
    if best is None:
        return text, False
    return text[:best], True


# ----------------------------------------------------------------------
# HTTP layer


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.0 + Connection: close keeps the stdlib server simple (no
    # chunked transfer encoding); SSE works the same way.
    protocol_version = "HTTP/1.0"
    frontend: OpenAIFrontend = None  # set by OpenAIHTTPServer

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _json(self, status: int, obj: Dict) -> None:
        data = json.dumps(obj).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body(self) -> Dict:
        n = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(n) if n else b""
        try:
            body = json.loads(raw or b"{}")
        except json.JSONDecodeError:
            raise APIError("request body is not valid JSON")
        if not isinstance(body, dict):
            raise APIError("request body must be a JSON object")
        return body

    def do_GET(self):
        fe = self.frontend
        if self.path == "/health":
            self._json(200, {"status": "ok"})
        elif self.path in ("/v1/models", "/models"):
            self._json(200, fe.models_response())
        elif self.path == "/metrics":
            data = fe.metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        else:
            self._json(404, APIError("not found", 404).to_json())

    def do_POST(self):
        fe = self.frontend
        try:
            body = self._body()
            if self.path in ("/v1/completions", "/completions"):
                if body.get("stream"):
                    self._sse(fe.completion_stream(body))
                else:
                    self._json(200, fe.completion(body))
            elif self.path in ("/v1/chat/completions", "/chat/completions"):
                if body.get("stream"):
                    self._sse(fe.chat_completion_stream(body))
                else:
                    self._json(200, fe.chat_completion(body))
            else:
                self._json(404, APIError("not found", 404).to_json())
        except APIError as e:
            self._json(e.status, e.to_json())
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _sse(self, chunks) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        try:
            for c in chunks:
                self.wfile.write(b"data: " + json.dumps(c).encode("utf-8")
                                 + b"\n\n")
                self.wfile.flush()
            self.wfile.write(b"data: [DONE]\n\n")
        except (BrokenPipeError, ConnectionResetError):
            chunks.close()  # GeneratorExit inside -> engine.cancel


class OpenAIHTTPServer:
    """Threaded HTTP server around an :class:`OpenAIFrontend`.

    Usage:
        server = ModernBatchServer(model, page_size=16, total_pages=...)
        engine = ServingEngine(server, decode_steps=8)
        api = OpenAIHTTPServer(OpenAIFrontend(engine, tokenizer),
                               port=8000)
        api.start()          # returns; api.port has the bound port
        ...
        api.shutdown()

    ``port=0`` binds an ephemeral port (tests). The engine step loop
    starts/stops with the server."""

    def __init__(self, frontend: OpenAIFrontend, host: str = "127.0.0.1",
                 port: int = 8000):
        self.frontend = frontend
        handler = type("BoundHandler", (_Handler,), {"frontend": frontend})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> None:
        self.frontend.start()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="lamp-http")
        self._thread.start()

    def serve_forever(self) -> None:
        self.frontend.start()
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self.frontend.close()
