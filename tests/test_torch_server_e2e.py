"""End-to-end HTTP flow of the port's server on the CPU, mirroring
tests/test_server_e2e.py::test_full_cortex_flow (load -> status/models/
metrics -> two streamed chats -> non-stream chat with logprobs ->
embeddings from the LLM -> unload), plus what this slice refuses at
/loadmodel, plus greedy completions (plain, through context shifts, with
a system prompt and a stop word) whose text equals the JAX server's for
the same f32 model and request, at each KV cache type and with
self-extend (grp_attn_n > 1)."""

import base64
import json
import socket
import threading
import urllib.request

import numpy as np
import pytest
import torch

from tests.models import build_test_gguf
from tpu_engine_torch.api.server import make_server

torch.set_num_threads(2)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _serve(make):
    port = _free_port()
    srv = make(port)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, f"http://127.0.0.1:{port}"


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("srv")
    q8 = build_test_gguf(str(d / "tiny_q8.gguf"), "q8_0", seed=3)
    f32 = build_test_gguf(str(d / "tiny_f32.gguf"), "f32", seed=3)
    return q8, f32


@pytest.fixture(scope="module")
def server():
    srv, base = _serve(lambda port: make_server("127.0.0.1", port,
                                                device="cpu"))
    yield base
    srv.shutdown()
    srv.registry.unload_all()


def post(base, path, body, timeout=300.0):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.status, json.loads(r.read())


def sse_chat(base, body, timeout=300.0):
    req = urllib.request.Request(
        base + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    chunks = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        assert r.headers.get("Content-Type", "").startswith("text/event-stream")
        for line in r:
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            payload = line[len(b"data: "):]
            if payload == b"[DONE]":
                break
            chunks.append(json.loads(payload))
    return chunks


LOAD = {"model_alias": "tinyllama", "model": "tinyllama", "ctx_len": 256,
        "n_parallel": 2, "engine": "cortex.llamacpp"}


def test_full_cortex_flow(server, models):
    base = server
    status, resp = post(base, "/loadmodel",
                        {**LOAD, "llama_model_path": models[0]})
    assert status == 200, resp

    status, resp = post(base, "/modelstatus", {"model": "tinyllama"})
    assert status == 200 and resp["model_loaded"]
    status, resp = get(base, "/models")
    assert status == 200
    assert resp["data"][0]["id"] == "tinyllama"
    assert int(resp["data"][0]["model_size"]) > 0
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        body = r.read().decode()
    assert "tpu_engine_models_loaded 1" in body
    assert 'tpu_engine_slots_busy{model="tinyllama"}' in body

    for i in range(2):
        chunks = sse_chat(base, {
            "model": "tinyllama", "stream": True, "max_tokens": 8,
            "temperature": 0,
            "messages": [{"role": "user", "content": f"hello world {i}"}],
            "stream_options": {"include_usage": True},
        })
        assert chunks[0]["choices"][0]["delta"].get("role") == "assistant"
        finishes = [c["choices"][0]["finish_reason"] for c in chunks
                    if c["choices"]]
        assert finishes[-1] in ("stop", "length")
        usage = [c for c in chunks if c.get("usage")]
        assert usage and usage[-1]["usage"]["total_tokens"] > 0

    status, resp = post(base, "/v1/chat/completions", {
        "model": "tinyllama", "max_tokens": 4, "temperature": 0,
        "logprobs": True, "top_logprobs": 3,
        "messages": [{"role": "user", "content": "hi"}],
    })
    assert status == 200
    choice = resp["choices"][0]
    assert resp["object"] == "chat.completion"
    assert resp["usage"]["completion_tokens"] > 0
    assert len(choice["logprobs"]["content"]) > 0
    assert len(choice["logprobs"]["content"][0]["top_logprobs"]) >= 3

    status, resp = post(base, "/v1/embeddings", {
        "model": "tinyllama", "input": ["hello world", "the quick brown fox"]})
    assert status == 200 and len(resp["data"]) == 2
    v = np.asarray(resp["data"][0]["embedding"])
    np.testing.assert_allclose(np.linalg.norm(v), 1.0, rtol=1e-4)
    status, resp = post(base, "/v1/embeddings", {
        "model": "tinyllama", "input": "hello world",
        "encoding_format": "base64"})
    assert status == 200
    v64 = np.frombuffer(base64.b64decode(resp["data"][0]["embedding"]),
                        np.float32)
    np.testing.assert_allclose(np.linalg.norm(v64), 1.0, rtol=1e-4)
    status, resp = post(base, "/v1/embeddings",
                        {"model": "tinyllama", "input": [1, 5, 9]})
    assert status == 200 and len(resp["data"]) == 1
    status, resp = post(base, "/v1/embeddings", {"model": "nope", "input": "x"})
    assert status == 409

    status, resp = post(base, "/unloadmodel", {"model": "tinyllama"})
    assert status == 200
    status, resp = post(base, "/modelstatus", {"model": "tinyllama"})
    assert status == 409


@pytest.mark.parametrize("extra,what", [
    ({"mmproj": "/nonexistent/mmproj.gguf"}, "multimodal"),
    ({"tensor_parallel": 2}, "tensor_parallel"),
    ({"data_parallel": 2}, "data_parallel"),
    ({"tensor_parallel": "2"}, "tensor_parallel=2"),
])
def test_loadmodel_refuses_later_slices(server, models, extra, what):
    status, resp = post(base := server, "/loadmodel",
                        {**LOAD, "model": "refused", "model_alias": "refused",
                         "llama_model_path": models[0], **extra})
    assert status == 400
    assert "not yet supported by tpu_engine_torch" in resp["error"]
    assert what in resp["error"]
    status, _ = post(base, "/modelstatus", {"model": "refused"})
    assert status == 409


def test_loadmodel_causal_embedding(server, models):
    """A causal GGUF loaded with model_type "embedding" is served (by
    InferenceEngine's embedding path, no warm-up): /v1/embeddings gives
    unit vectors, as in the JAX package."""
    status, resp = post(server, "/loadmodel",
                        {**LOAD, "model": "emb", "model_alias": "emb",
                         "llama_model_path": models[0],
                         "model_type": "embedding"})
    assert status == 200, resp
    status, resp = post(server, "/v1/embeddings",
                        {"model": "emb", "input": ["hello world", [1, 5, 9]]})
    assert status == 200 and len(resp["data"]) == 2, resp
    for d in resp["data"]:
        np.testing.assert_allclose(np.linalg.norm(d["embedding"]), 1.0,
                                   rtol=1e-4)
    status, _ = post(server, "/unloadmodel", {"model": "emb"})
    assert status == 200


def test_loadmodel_tensor_parallel_auto(server, models):
    """tensor_parallel "auto" resolves, as in the JAX package, to the
    attached devices over data_parallel: 1 on the CPU, served unsharded
    with the same greedy text as "1". "auto" beside more data_parallel
    than devices is not a valid grid, with the JAX package's message."""
    texts = []
    for tp in ("auto", 1):
        mid = f"tp-{tp}"
        status, resp = post(server, "/loadmodel",
                            {**LOAD, "model": mid, "model_alias": mid,
                             "llama_model_path": models[0],
                             "tensor_parallel": tp})
        assert status == 200, resp
        status, resp = post(server, "/v1/chat/completions", {
            "model": mid, "max_tokens": 6, "temperature": 0,
            "messages": [{"role": "user", "content": "hello world"}]})
        assert status == 200, resp
        texts.append(resp["choices"][0]["message"]["content"])
        status, _ = post(server, "/unloadmodel", {"model": mid})
        assert status == 200
    assert texts[0] == texts[1]
    status, resp = post(server, "/loadmodel",
                        {**LOAD, "model": "grid", "model_alias": "grid",
                         "llama_model_path": models[0],
                         "tensor_parallel": "auto", "data_parallel": 2})
    assert status == 400
    assert resp["error"] == ("tensor_parallel=0 x data_parallel=2 is not a "
                             "valid grid for 1 attached devices")


@pytest.mark.parametrize("cache_type", ["q8_0", "q4_0", "q5_1"])
def test_loadmodel_serves_quantized_kv(server, models, cache_type):
    """Quantized KV loads (stored "dt", as kvcache.default_layout picks)
    and serves a chat; an unknown cache_type (q5_1) warns and serves as
    f16, as the reference does."""
    mid = f"kv-{cache_type}"
    status, resp = post(server, "/loadmodel",
                        {**LOAD, "model": mid, "model_alias": mid,
                         "llama_model_path": models[0],
                         "cache_type": cache_type})
    assert status == 200, resp
    status, resp = post(server, "/v1/chat/completions", {
        "model": mid, "max_tokens": 6, "temperature": 0,
        "messages": [{"role": "user", "content": "hello world"}]})
    assert status == 200, resp
    assert 0 < resp["usage"]["completion_tokens"] <= 6
    status, _ = post(server, "/unloadmodel", {"model": mid})
    assert status == 200


@pytest.fixture(scope="module")
def twins(models):
    """The port's server and the JAX server, each with the same f32 model
    loaded at 64 cells per slot (so long requests context-shift), once per
    KV cache type: model "twin" at f16, "twin-q8_0" and "twin-q4_0"; and
    with self-extend (grp_attn_n 4, grp_attn_w 16, K stored unrotated) at
    f16 ("twin-se") and q8_0 ("twin-se-q8_0")."""
    from tpu_engine.api.server import make_server as jax_make_server

    srvs = [_serve(lambda port: make_server("127.0.0.1", port, device="cpu")),
            _serve(lambda port: jax_make_server("127.0.0.1", port))]
    se = {"grp_attn_n": 4, "grp_attn_w": 16}
    for model, cache_type, extra in (
            ("twin", "f16", {}), ("twin-q8_0", "q8_0", {}),
            ("twin-q4_0", "q4_0", {}), ("twin-se", "f16", se),
            ("twin-se-q8_0", "q8_0", se)):
        load = {"model": model, "llama_model_path": models[1],
                "ctx_len": 128, "n_parallel": 2, "cache_type": cache_type,
                **extra}
        for _, base in srvs:
            status, resp = post(base, "/loadmodel", load)
            assert status == 200, resp
    yield [base for _, base in srvs]
    for srv, _ in srvs:
        srv.shutdown()
        srv.registry.unload_all()


TWIN_REQUESTS = {
    "plain": {"max_tokens": 12,
              "messages": [{"role": "user", "content": "the quick brown fox"}]},
    # 62 prompt tokens + 90 generated > 64 cells: the slot context-shifts
    # (kvcache.shift_compact with re-rope) several times
    "context_shift": {"max_tokens": 90, "messages": [
        {"role": "user",
         "content": "the quick brown fox jumps over the lazy dog"}]},
    "system_and_stop": {"max_tokens": 40, "stop": ["fox"], "messages": [
        {"role": "system", "content": "you are a dog"},
        {"role": "user", "content": "hello world"}]},
}


def _twin_outputs(twins, model, case):
    req = {"model": model, "temperature": 0, **TWIN_REQUESTS[case]}
    outs = []
    for base in twins:
        status, resp = post(base, "/v1/chat/completions", req)
        assert status == 200, resp
        outs.append((resp["choices"][0]["message"]["content"], resp["usage"],
                     resp["choices"][0]["finish_reason"]))
    assert outs[0][1]["completion_tokens"] > 0
    return outs


@pytest.mark.parametrize("case", sorted(TWIN_REQUESTS))
def test_greedy_text_matches_jax_server(twins, case):
    """Same f32 model, same greedy request: the port's server and the JAX
    server return the same text, usage and finish reason."""
    outs = _twin_outputs(twins, "twin", case)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("cache_type", ["q8_0", "q4_0"])
@pytest.mark.parametrize("case", sorted(TWIN_REQUESTS))
def test_greedy_text_matches_jax_server_quantized_kv(twins, case, cache_type):
    """The same at cache_type q8_0 / q4_0: both servers quantize the same
    rows to the same bytes, and the context-shift request requantizes the
    re-roped K cells of a quantized "dt" cache."""
    outs = _twin_outputs(twins, f"twin-{cache_type}", case)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("model", ["twin-se", "twin-se-q8_0"])
@pytest.mark.parametrize("case", sorted(TWIN_REQUESTS))
def test_greedy_text_matches_jax_server_self_extend(twins, case, model):
    """The same with self-extend at f16 and q8_0: both servers store K
    unrotated and rotate it by the remapped cell positions; the
    context-shift request shifts the unrotated cache without re-rope."""
    outs = _twin_outputs(twins, model, case)
    assert outs[0] == outs[1]
