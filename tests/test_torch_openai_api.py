"""The OpenAI-compatible front end on the port: the cases of
tests/test_openai_api.py over real sockets on port 0, against
lamp_tpu_torch's OpenAIFrontend / OpenAIHTTPServer on a tiny byte-level
ModernLM (2 blocks, 64 wide, 4 heads, vocab 256, context 64) that
lamp_tpu makes from a seeded key and the bridge carries across. The same
model also serves behind lamp_tpu's front end: for the same bodies the
greedy completions' text, finish_reason and usage are equal (exact: both
engines run f32 on CPU, and their greedy tokens agree, as
tests/test_torch_serving.py holds them).
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import pytest

from lamp_tpu import nn as jnn
from lamp_tpu.data.tokenizer import IdentityCodec as JaxCodec
from lamp_tpu.models.openai_api import OpenAIFrontend as JaxFrontend
from lamp_tpu.models.openai_api import OpenAIHTTPServer as JaxHTTPServer
from lamp_tpu.models.serving import ModernBatchServer as JaxServer
from lamp_tpu.models.serving import ServingEngine as JaxEngine
from lamp_tpu_torch.bridge import load_modern_lm
from lamp_tpu_torch.data import IdentityCodec
from lamp_tpu_torch.models import (ModernBatchServer, SamplingParams,
                                   ServingEngine)
from lamp_tpu_torch.models.openai_api import (APIError, OpenAIFrontend,
                                              OpenAIHTTPServer,
                                              _apply_stop_strings,
                                              default_chat_template)
from lamp_tpu.models import openai_api as jax_api

from .test_torch_modern import jax_params


def _jax_model(**kw):
    cfg = dict(vocab_size=256, context_length=64, num_blocks=2, embed_dim=64,
               num_heads=4, key=jax.random.PRNGKey(0))
    cfg.update(kw)
    return jnn.ModernLM.init(**cfg)


def _fronts():
    jm = _jax_model()
    tm = load_modern_lm(jax_params(jm), device="cpu")
    port = OpenAIHTTPServer(OpenAIFrontend(
        ServingEngine(ModernBatchServer(tm, page_size=8, total_pages=64),
                      decode_steps=4, max_batch=8),
        IdentityCodec(), model_name="tiny-byte-lm", default_max_tokens=8),
        port=0)
    ref = JaxHTTPServer(JaxFrontend(
        JaxEngine(JaxServer(jm, page_size=8, total_pages=64),
                  decode_steps=4, max_batch=8),
        JaxCodec(), model_name="tiny-byte-lm", default_max_tokens=8),
        port=0)
    return port, ref


@pytest.fixture(scope="module")
def servers():
    port, ref = _fronts()
    port.start()
    ref.start()
    yield port, ref
    port.shutdown()
    ref.shutdown()


@pytest.fixture(scope="module")
def api(servers):
    return servers[0]


def _post(api, path, body, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{api.port}{path}",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _post_stream(api, path, body, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{api.port}{path}",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    chunks, done = [], False
    with urllib.request.urlopen(req, timeout=timeout) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":
                done = True
            else:
                chunks.append(json.loads(payload))
    assert done
    return chunks


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "hello", "temperature": 0.0,
                         "max_tokens": 6}),
    ("/v1/completions", {"prompt": "once upon ", "temperature": 0.0,
                         "max_tokens": 12, "stop": ["e", "zz"]}),
    ("/v1/completions", {"prompt": "x" * 50, "temperature": 0.0,
                         "max_tokens": 40}),
    ("/v1/chat/completions", {"messages": [{"role": "user",
                                            "content": "hi"}],
                              "temperature": 0.0, "max_tokens": 5}),
], ids=["plain", "stop", "context_edge", "chat"])
def test_greedy_completions_equal_the_jax_front_end(servers, path, body):
    port, ref = servers
    got, want = _post(port, path, body), _post(ref, path, body)
    assert got["usage"] == want["usage"]
    assert got["object"] == want["object"]
    for g, w in zip(got["choices"], want["choices"], strict=True):
        assert g["finish_reason"] == w["finish_reason"]
        assert g.get("text") == w.get("text")
        assert g.get("message") == w.get("message")


def test_models_and_health(api):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{api.port}/health", timeout=30) as r:
        assert json.loads(r.read())["status"] == "ok"
    with urllib.request.urlopen(
            f"http://127.0.0.1:{api.port}/v1/models", timeout=30) as r:
        doc = json.loads(r.read())
    assert doc["data"][0]["id"] == "tiny-byte-lm"


def test_completion_greedy_deterministic(api):
    body = {"prompt": "hello", "temperature": 0.0, "max_tokens": 6}
    a = _post(api, "/v1/completions", body)
    b = _post(api, "/v1/completions", body)
    assert a["object"] == "text_completion"
    assert a["choices"][0]["text"] == b["choices"][0]["text"]
    assert a["choices"][0]["finish_reason"] == "length"
    assert a["usage"] == {"prompt_tokens": 5, "completion_tokens": 6,
                          "total_tokens": 11}


def test_completion_stream_matches_nonstream(api):
    body = {"prompt": "abc", "temperature": 0.0, "max_tokens": 6}
    full = _post(api, "/v1/completions", body)["choices"][0]["text"]
    chunks = _post_stream(api, "/v1/completions", dict(body, stream=True))
    assert "".join(c["choices"][0]["text"] for c in chunks) == full
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"


def test_stop_string_cuts_generation(api):
    body = {"prompt": "xyz", "temperature": 0.0, "max_tokens": 8}
    full = _post(api, "/v1/completions", body)["choices"][0]["text"]
    assert len(full) >= 3
    stop = full[2:4]
    cut = _post(api, "/v1/completions", dict(body, stop=stop))
    assert cut["choices"][0]["text"] == full[:full.find(stop)]
    assert cut["choices"][0]["finish_reason"] == "stop"
    chunks = _post_stream(api, "/v1/completions",
                          dict(body, stop=stop, stream=True))
    assert "".join(c["choices"][0]["text"] for c in chunks) == \
        full[:full.find(stop)]
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
    assert not api.frontend.engine.server.seq_pages  # pages freed


def test_chat_completion_roundtrip(api):
    body = {"messages": [{"role": "user", "content": "hi"}],
            "temperature": 0.0, "max_tokens": 5}
    resp = _post(api, "/v1/chat/completions", body)
    assert resp["object"] == "chat.completion"
    msg = resp["choices"][0]["message"]
    assert msg["role"] == "assistant" and isinstance(msg["content"], str)
    chunks = _post_stream(api, "/v1/chat/completions",
                          dict(body, stream=True))
    assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
    assert "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks) == msg["content"]


def test_parallel_sampling_n(api):
    body = {"prompt": "seed", "temperature": 1.0, "max_tokens": 4, "n": 2,
            "logprobs": True}
    resp = _post(api, "/v1/completions", body)
    assert [c["index"] for c in resp["choices"]] == [0, 1]
    for c in resp["choices"]:
        assert len(c["logprobs"]["token_logprobs"]) == len(
            c["logprobs"]["tokens"])
    assert resp["usage"]["completion_tokens"] == sum(
        len(c["logprobs"]["tokens"]) for c in resp["choices"])


def test_concurrent_requests_batch(api):
    body = {"prompt": "hello", "temperature": 0.0, "max_tokens": 6}
    expected = _post(api, "/v1/completions", body)["choices"][0]["text"]
    out, errs = [None] * 4, []

    def hit(i):
        try:
            out[i] = _post(api, "/v1/completions", body)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errs
    assert all(r["choices"][0]["text"] == expected for r in out)


@pytest.mark.parametrize("body", [
    {"prompt": 7},
    {"prompt": "x", "temperature": -1.0},
    {"prompt": "x", "max_tokens": 0},
    {"prompt": "x", "n": 2, "temperature": 0.0},
    {"prompt": "x" * 500},
    {"prompt": "x", "stream": True, "n": 2, "temperature": 1.0},
], ids=["prompt_type", "temperature", "max_tokens", "n_greedy",
        "too_long", "stream_n"])
def test_bad_requests_return_400(servers, body):
    for server in servers:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server, "/v1/completions", body)
        assert ei.value.code == 400
        assert "error" in json.loads(ei.value.read())


def test_malformed_body_returns_400(api):
    req = urllib.request.Request(
        f"http://127.0.0.1:{api.port}/v1/completions", data=b"{not json",
        method="POST", headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400


def test_engine_cancel_frees_pages():
    tm = load_modern_lm(jax_params(_jax_model(
        vocab_size=64, context_length=32, num_blocks=1, embed_dim=32,
        num_heads=2, key=jax.random.PRNGKey(1))), device="cpu")
    server = ModernBatchServer(tm, page_size=8, total_pages=16)
    engine = ServingEngine(server, decode_steps=2, max_batch=4)
    free0 = server.available_pages
    a = engine.submit([1, 2, 3], SamplingParams(max_tokens=20))
    b = engine.submit([4, 5], SamplingParams(max_tokens=4))
    engine.step()
    assert a in server.seq_pages and b in server.seq_pages
    assert engine.cancel(a)
    assert a not in server.seq_pages
    assert not engine.cancel(a)
    c = engine.submit([7, 8], SamplingParams(temperature=1.0, max_tokens=4),
                      n=2)
    assert engine.cancel(c)
    results = engine.run()
    assert set(results) == {b}
    assert len(results[b]) <= 4
    assert server.available_pages == free0


def test_stop_strings_and_chat_template_equal_jax():
    for text, stop in (("abcdef", ["cd", "e"]), ("abcdef", []),
                       ("abc", ["zz"]), ("abab", ["", "b"])):
        assert _apply_stop_strings(text, stop) == \
            jax_api._apply_stop_strings(text, stop)
    msgs = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "hi"}]
    assert default_chat_template(msgs) == jax_api.default_chat_template(msgs)
    with pytest.raises(APIError):
        default_chat_template([{"role": "user", "content": 3}])


def test_frontend_direct_api_error():
    tm = load_modern_lm(jax_params(_jax_model(
        vocab_size=64, context_length=32, num_blocks=1, embed_dim=32,
        num_heads=2, key=jax.random.PRNGKey(1))), device="cpu")
    fe = OpenAIFrontend(ServingEngine(ModernBatchServer(
        tm, page_size=8, total_pages=16)), IdentityCodec())
    with pytest.raises(APIError):
        fe.completion({"prompt": ""})
    with pytest.raises(APIError):
        fe.chat_completion({"messages": []})


def test_metrics_endpoint(api):
    _post(api, "/v1/completions", {"prompt": "m", "temperature": 0.0,
                                   "max_tokens": 3})
    with urllib.request.urlopen(
            f"http://127.0.0.1:{api.port}/metrics", timeout=30) as r:
        text = r.read().decode()
    metrics = {line.split()[0]: float(line.split()[1])
               for line in text.splitlines() if not line.startswith("#")}
    assert metrics["lamp_requests_total"] >= 1
    assert metrics["lamp_generated_tokens_total"] >= 3
    assert metrics["lamp_requests_running"] == 0
    assert metrics["lamp_requests_pending"] == 0
    # the pool less its trash page is free again
    assert metrics["lamp_kv_pages_free"] == metrics["lamp_kv_pages_total"] - 1
