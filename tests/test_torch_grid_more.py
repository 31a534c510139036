"""Loads a tensor x data parallel grid serves beside text generation, and
the sampler's two lanes, on the CPU against the JAX package (the mmproj
image chat on grids is in tests/test_torch_multihost.py):

  - a projector narrower than the LLM is refused on a grid, before any
    process starts, with the JAX registry's message;
  - a tiny nomic-bert asked for at tensor_parallel 2 is served whole, with
    no process spawned: its vectors are the 1x1 load's bit for bit (at f32
    and at the Q4_K_M mix), and the JAX registry's at f32;
  - a causal GGUF loaded as model_type "embedding" at TP=2 (within 1e-6 of
    1x1, and 1e-5 of the JAX registry's TP=2) and DP=2 (equal to 1x1);
  - chip_smoke's burst through the port's server that mixes the
    sampler's lanes (free requests at temperature 0.8, a grammar that
    determinizes into the device bank, a json_schema, a recursive grammar,
    a seeded request and a logprobs request): the lane each took, grammar
    text its grammar accepts, seeded repeats equal, and the greedy
    logprobs, sent alone, within 1e-5 of the JAX server's.

Grid ranks are gloo processes on the CPU (the registry spawns them). The
JAX registries run on the conftest's virtual CPU devices with their
warm-up skipped (it compiles ahead and changes no output). The grid and
encoder tests fail on the tree before grids served these loads: the
port's registry refused them ("serves text generation only"); the burst
and grammar_verdict tests pass there too.
"""

import json
import multiprocessing
import socket
import threading
import urllib.request

import numpy as np
import pytest
import torch

from tests.models import build_test_gguf
from tests.test_clip import tiny_hf_clip, write_mmproj
from tests.test_torch_bert import NOMIC
from tpu_engine_torch.tools.encoder_gguf import build_nomic_bert_gguf

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _quick(monkeypatch):
    """f32 scales on the JAX side (as the port keeps them), short decode
    chunks, and no JAX warm-up compile."""
    from tpu_engine.serve.engine import InferenceEngine as JEngine

    monkeypatch.setenv("TPU_ENGINE_BF16_SCALES", "0")
    monkeypatch.setenv("TPU_ENGINE_DECODE_CHUNK", "8")
    monkeypatch.setattr(JEngine, "warm_up", lambda self, *a, **kw: None)


@pytest.fixture(scope="module")
def llm(tmp_path_factory):
    """The tiny llama (4 heads, 2 kv heads: both divide at p = 2)."""
    d = tmp_path_factory.mktemp("grid_llm")
    return build_test_gguf(str(d / "tiny.gguf"), "q8_0", seed=3)


def _serve(make):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = make(port)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, th, f"http://127.0.0.1:{port}"


def _stop(srv, th):
    srv.shutdown()
    srv.server_close()
    srv.registry.unload_all()
    th.join(timeout=30)


def _post(base, route, body):
    req = urllib.request.Request(base + route, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def _port_server():
    from tpu_engine_torch.api.server import make_server

    return _serve(lambda port: make_server("127.0.0.1", port, device="cpu",
                                           devices=["cpu"] * 2))


def _jax_server():
    from tpu_engine.api.server import make_server

    return _serve(lambda port: make_server("127.0.0.1", port))


# ------------------------------------------------------------------ mmproj
def test_grid_refuses_narrow_projector_before_any_process(llm, tmp_path):
    """On a grid this process holds no model before the followers start:
    the projector width is read against the GGUF header, and refused with
    the JAX registry's message before any process starts."""
    from tpu_engine.serve.registry import EngineRegistry as JReg
    from tpu_engine_torch.serve.registry import EngineRegistry as TReg

    wide = write_mmproj(str(tmp_path / "wide.gguf"), tiny_hf_clip())[0]
    body = {"llama_model_path": llm, "model": "m", "mmproj": wide,
            "tensor_parallel": 2, "n_parallel": 2}
    got = TReg(device="cpu", devices=["cpu"] * 2).load_model(dict(body))
    assert multiprocessing.active_children() == []
    assert got == JReg().load_model(dict(body))
    assert not got[0] and got[1].startswith(
        "embedding dim of the multimodal projector (48)")


# -------------------------------------------------------------- embeddings
def _vectors(base, model, inputs):
    status, resp = _post(base, "/v1/embeddings",
                         {"model": model, "input": inputs})
    assert status == 200, resp
    return np.asarray([d["embedding"] for d in resp["data"]], np.float64)


EMBED_INPUTS = ["the quick brown fox", "hello world", "a b c d e f g"]


@pytest.mark.parametrize("level", ["f32", "q4_k_m"])
def test_encoder_on_a_grid_is_served_whole(tmp_path, level):
    """nomic-bert asked for at tensor_parallel 2: one EncoderEngine on the
    first device and no process spawned; vectors equal to the 1x1 load's
    bit for bit, and (f32) within 1e-5 of the JAX registry's TP=2 load,
    which serves it whole too. The JAX registry refuses the Q4_K_M mix
    at TP=2 (its kernel layout's perm_shards); the port has no such
    layout and serves it."""
    path = str(tmp_path / f"nomic_{level}.gguf")
    build_nomic_bert_gguf(path, level=level, widths=NOMIC, seed=4)
    inputs = [[2, 5, 6, 7, 8, 3], [2, 19, 20, 22, 23, 30, 31, 3]]
    load = {"llama_model_path": path, "model": "e", "ctx_len": 64,
            "model_type": "embedding"}
    vecs = {}
    srv, th, base = _port_server()
    try:
        for grid in ({}, {"tensor_parallel": 2}):
            status, resp = _post(base, "/loadmodel", {**load, **grid})
            assert status == 200, resp
            entry = srv.registry.get("e")
            assert entry.grid is None and entry.load_body == {**load, **grid}
            assert type(entry.engine).__name__ == "EncoderEngine"
            assert multiprocessing.active_children() == []
            vecs[json.dumps(grid)] = _vectors(base, "e", inputs)
            assert _post(base, "/unloadmodel", {"model": "e"})[0] == 200
    finally:
        _stop(srv, th)
    np.testing.assert_array_equal(vecs["{}"], vecs['{"tensor_parallel": 2}'])
    if level == "f32":
        srv, th, base = _jax_server()
        try:
            status, resp = _post(base, "/loadmodel",
                                 {**load, "tensor_parallel": 2})
            assert status == 200, resp
            ref = _vectors(base, "e", inputs)
        finally:
            _stop(srv, th)
        np.testing.assert_allclose(vecs["{}"], ref, rtol=0, atol=1e-5)


def test_causal_embedding_model_on_grids(llm):
    """The tiny llama as model_type "embedding" (mean pooling of the
    hidden states, carried with every step to the grid's followers): TP=2
    within 1e-6 of 1x1 (the ranks' partial sums add in another order),
    DP=2 equal to it, and TP=2 within 1e-5 of the JAX registry's TP=2."""
    load = {"llama_model_path": llm, "model": "c", "ctx_len": 128,
            "n_parallel": 2, "model_type": "embedding"}
    vecs = {}
    srv, th, base = _port_server()
    try:
        for grid in ({}, {"tensor_parallel": 2}, {"data_parallel": 2}):
            status, resp = _post(base, "/loadmodel", {**load, **grid})
            assert status == 200, resp
            entry = srv.registry.get("c")
            assert (entry.grid is not None) == bool(grid)
            assert entry.opts["embedding"]
            vecs[json.dumps(grid)] = _vectors(base, "c", EMBED_INPUTS)
            assert _post(base, "/unloadmodel", {"model": "c"})[0] == 200
            assert multiprocessing.active_children() == []
    finally:
        _stop(srv, th)
    srv, th, base = _jax_server()
    try:
        status, resp = _post(base, "/loadmodel", {**load,
                                                  "tensor_parallel": 2})
        assert status == 200, resp
        ref = _vectors(base, "c", EMBED_INPUTS)
    finally:
        _stop(srv, th)
    one = vecs["{}"]
    assert one.shape == (len(EMBED_INPUTS), 256)
    np.testing.assert_allclose(vecs['{"tensor_parallel": 2}'], one, rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(vecs['{"data_parallel": 2}'], one)
    np.testing.assert_allclose(vecs['{"tensor_parallel": 2}'], ref, rtol=0,
                               atol=1e-5)


# ------------------------------------------------------------ sampler lanes
def test_mixed_burst_takes_both_lanes(llm, monkeypatch):
    """chip_smoke's mixed burst (lane_burst: three free requests at
    temperature 0.8, a grammar that determinizes into the device bank, a
    json_schema, a recursive grammar, a seeded request, a greedy logprobs
    request) at once through the port's server: each on its expected lane
    (read from the slot's gstate and _on_device at launch), grammar and
    json_schema text its grammar accepts (whole when it stopped, a prefix
    at the length limit), the seeded request twice in a row with equal
    text, every logprobs entry's token its top entry, and the logprobs
    request, sent again alone, within 1e-5 of the JAX server's (alone
    too)."""
    from chip_smoke import grammar_verdict, lane_burst, schema_holds
    from tpu_engine_torch.serve.engine import InferenceEngine

    burst = lane_burst()
    lanes = {}
    launch = InferenceEngine._launch_slot

    def record(self, slot, task):
        launch(self, slot, task)
        lanes[task.params.n_predict] = (
            "host" if not self._on_device(slot) else
            "device" if slot.gstate is None else "bank")

    monkeypatch.setattr(InferenceEngine, "_launch_slot", record)
    load = {"llama_model_path": llm, "model": "samp", "ctx_len": 1024,
            "n_parallel": 8, "caching_enabled": False}
    results = [None] * len(burst)
    srv, th, base = _port_server()
    try:
        status, resp = _post(base, "/loadmodel", load)
        assert status == 200, resp
        engine = srv.registry.get("samp").engine
        chunks = engine.n_chunks_dispatched

        def worker(i):
            results[i] = _post(base, "/v1/chat/completions", burst[i][2])

        ths = [threading.Thread(target=worker, args=(i,))
               for i in range(len(burst))]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=300)
        seeded = [_post(base, "/v1/chat/completions", burst[6][2])
                  for _ in range(2)]
        lone = _post(base, "/v1/chat/completions", burst[7][2])[1]
        assert engine.n_chunks_dispatched > chunks and engine.n_host_steps
    finally:
        _stop(srv, th)
    for (lane, grammar, body), (status, resp) in zip(burst, results):
        assert status == 200, resp
        assert lanes[body["max_tokens"]] == lane, (body, lanes)
        if grammar is None:
            continue
        choice = resp["choices"][0]
        verdict = grammar_verdict(grammar, choice["message"]["content"])
        assert verdict == "full" or (
            verdict == "prefix" and choice["finish_reason"] == "length"), \
            (body, choice)
        if "response_format" in body and verdict == "full":
            assert schema_holds(json.loads(choice["message"]["content"]))
    texts = [r[1]["choices"][0]["message"]["content"] for r in seeded]
    assert texts[0] == texts[1]
    for entry in results[7][1]["choices"][0]["logprobs"]["content"]:
        assert entry["token"] == entry["top_logprobs"][0]["token"]
        assert len(entry["top_logprobs"]) == 5
    # alone on both servers, no prompt cache (a burst's schedule moves the
    # logits by ~1e-4)
    srv, th, base = _jax_server()
    try:
        status, resp = _post(base, "/loadmodel", load)
        assert status == 200, resp
        status, ref = _post(base, "/v1/chat/completions", burst[7][2])
        assert status == 200, ref
    finally:
        _stop(srv, th)
    got = lone["choices"][0]["logprobs"]["content"]
    want = ref["choices"][0]["logprobs"]["content"]
    assert lone["choices"][0]["message"]["content"] == \
        ref["choices"][0]["message"]["content"]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["token"] == g["top_logprobs"][0]["token"] == w["token"]
        for a, b in zip(g["top_logprobs"], w["top_logprobs"]):
            assert a["token"] == b["token"]
            assert abs(a["logprob"] - b["logprob"]) <= 1e-5


def test_grammar_verdict():
    """chip_smoke's text check of a grammar: whole, prefix, or neither;
    the burst's json_schema determinizes into the device bank."""
    from chip_smoke import (GRAMMAR_DFA, GRAMMAR_REC, SCHEMA, grammar_verdict,
                            schema_holds)
    from tpu_engine_torch.grammar import json_schema_to_grammar
    from tpu_engine_torch.grammar.dfa import compile_byte_dfa

    assert grammar_verdict(GRAMMAR_DFA, "answer: no.") == "full"
    assert grammar_verdict(GRAMMAR_DFA, "answer: ma") == "prefix"
    assert grammar_verdict(GRAMMAR_DFA, "answer: x") is None
    assert grammar_verdict(GRAMMAR_REC, "((ab))") == "full"
    assert grammar_verdict(GRAMMAR_REC, "((ab)") == "prefix"
    assert compile_byte_dfa(GRAMMAR_REC, 126) is None
    schema = json_schema_to_grammar(SCHEMA)
    assert compile_byte_dfa(schema, 126) is not None
    text = '{"answer": "maybe", "count": 12, "sure": false}'
    assert grammar_verdict(schema, text) == "full"
    assert schema_holds(json.loads(text))
