"""The port's leader and followers (tpu_engine_torch/dist/multihost.py)
on the CPU, and the registry serving a grid over HTTP:

  - rank 0's engine (start_leader) plus follower processes
    (serve_follower) serve four greedy requests with the single-process
    engine's texts, at q8_0 KV under tensor_parallel 2, and with a system
    prompt (seq_cp from a slot of one data rank into the other's) under
    data_parallel 2; verify_state is true: every rank sampled the same
    tokens from the same logits, bit for bit, and each model group holds
    the same cache lengths; a follower one ulp off in a logit fails it;
  - the JAX package's two-process run (tests/test_multihost.py) is the
    model: its texts are those of one process too;
  - a registry built with devices ["cpu"] * 2 serves /loadmodel
    {"tensor_parallel": 2}, a chat and /unloadmodel, then the same with
    {"data_parallel": 2}: the chats give the 1x1 load's text, and no
    follower process is left after each /unloadmodel;
  - a backend the devices cannot run (nccl on the CPU) is refused at
    /loadmodel before any process starts; an mmproj is served on a TP=2
    and a DP=2 grid with the 1x1 load's and the JAX registry's image-chat
    tokens.
"""

import json
import multiprocessing
import socket
import threading
import urllib.request

import pytest
import torch

from tests.models import build_test_gguf
from tests.torch_dist_workers import leader_follower, run_group, serve_prompts
from tpu_engine_torch.model.loader import load_model

torch.set_num_threads(2)

PROMPTS = [[1, 30 + i, 40 + i, 50] for i in range(4)]


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return build_test_gguf(
        str(tmp_path_factory.mktemp("mh") / "tiny.gguf"), "q4_k_m", seed=9,
        n_heads=8, n_kv_heads=4, hidden_size=256, intermediate_size=256)


def _single_process(path, cache_type=None, system_prompt=None):
    from tpu_engine_torch.serve import InferenceEngine

    eng = InferenceEngine(load_model(path, device="cpu"), n_ctx=256,
                          n_parallel=4, prefill_buckets=(16,), decode_chunk=4,
                          cache_type=cache_type)
    try:
        return serve_prompts(eng, PROMPTS, 0.0, system_prompt)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("n_data,n_model,cache_type,system_prompt", [
    (1, 2, "q8_0", None), (2, 1, None, "you answer briefly")])
def test_leader_and_followers_serve_single_process_texts(
        path, tmp_path, n_data, n_model, cache_type, system_prompt):
    ref = _single_process(path, cache_type, system_prompt)
    got = run_group(leader_follower, n_data * n_model, str(tmp_path), path,
                    n_data, PROMPTS, (0.0,), 5, cache_type, system_prompt)
    (texts,), ok, state = got[0]
    assert ok, "the ranks' state diverged"
    assert state["steps_equal"] and state["tokens"] > 0
    assert texts == ref
    assert got[1:] == [None] * (n_data * n_model - 1)


def test_verify_state_sees_a_follower_logit_one_ulp_off(path, tmp_path):
    """A follower whose logits differ from the leader's in one bit, with
    the same greedy tokens, fails verify_state: the ranks' logits are
    compared bit for bit, not only their samples."""
    ref = _single_process(path)
    got = run_group(leader_follower, 2, str(tmp_path), path, 1, PROMPTS,
                    (0.0,), 5, None, None, True)
    (texts,), ok, state = got[0]
    assert texts == ref
    assert not ok and not state["steps_equal"]


def _post(base, route, body):
    req = urllib.request.Request(base + route, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def test_registry_serves_grids_and_leaves_no_process(path, monkeypatch):
    from tpu_engine_torch.api.server import make_server
    from tpu_engine_torch.dist.multihost import verify_engine

    monkeypatch.setenv("TPU_ENGINE_DECODE_CHUNK", "8")  # a short warm-up

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = make_server("127.0.0.1", port, device="cpu", devices=["cpu"] * 2)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{port}"
    chat = {"model": "m", "max_tokens": 12, "temperature": 0,
            "messages": [{"role": "user", "content": "hello world"}]}
    texts = {}
    try:
        for grid in ({}, {"tensor_parallel": 2}, {"data_parallel": 2}):
            status, resp = _post(base, "/loadmodel", {
                "llama_model_path": path, "model": "m", "ctx_len": 128,
                "n_parallel": 2, **grid})
            assert status == 200, resp
            entry = srv.registry.get("m")
            procs = entry.grid.procs if entry.grid else []
            assert len(procs) == (1 if grid else 0)
            assert all(p.is_alive() for p in procs)
            status, resp = _post(base, "/v1/chat/completions", chat)
            assert status == 200, resp
            assert resp["usage"]["completion_tokens"] >= 1
            texts[json.dumps(grid)] = resp["choices"][0]["message"]["content"]
            assert not grid or verify_engine(entry.engine)
            status, resp = _post(base, "/unloadmodel", {"model": "m"})
            assert status == 200, resp
            assert not any(p.is_alive() for p in procs)
            assert multiprocessing.active_children() == []
            assert not torch.distributed.is_initialized()
    finally:
        srv.shutdown()
        srv.server_close()
        srv.registry.unload_all()
        th.join(timeout=30)
    assert len(set(texts.values())) == 1, texts


def test_grid_load_applies_grammar_file(path, tmp_path, monkeypatch):
    """A grid load reads the body's grammar_file as a 1x1 load does: its
    chats follow the grammar, and a path that cannot be read is refused
    before any process starts."""
    from tpu_engine_torch.serve.registry import EngineRegistry
    from tpu_engine_torch.api.server import make_server

    monkeypatch.setenv("TPU_ENGINE_DECODE_CHUNK", "8")
    reg = EngineRegistry(device="cpu", devices=["cpu"] * 2)
    ok, msg = reg.load_model({"llama_model_path": path, "model": "m",
                              "tensor_parallel": 2,
                              "grammar_file": str(tmp_path / "missing")})
    assert not ok and "cannot read grammar_file" in msg
    assert multiprocessing.active_children() == []
    grammar = tmp_path / "yes_no.gbnf"
    grammar.write_text('root ::= "yes" | "no"\n')

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = make_server("127.0.0.1", port, device="cpu", devices=["cpu"] * 2)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{port}"
    try:
        status, resp = _post(base, "/loadmodel", {
            "llama_model_path": path, "model": "m", "ctx_len": 128,
            "n_parallel": 2, "tensor_parallel": 2,
            "grammar_file": str(grammar)})
        assert status == 200, resp
        entry = srv.registry.get("m")
        assert entry.grid is not None and entry.opts["grammar"]
        for content in ("hello world", "say something"):
            status, resp = _post(base, "/v1/chat/completions", {
                "model": "m", "max_tokens": 20, "temperature": 0,
                "messages": [{"role": "user", "content": content}]})
            assert status == 200, resp
            assert resp["choices"][0]["message"]["content"] in ("yes", "no")
        status, resp = _post(base, "/unloadmodel", {"model": "m"})
        assert status == 200, resp
        assert multiprocessing.active_children() == []
    finally:
        srv.shutdown()
        srv.server_close()
        srv.registry.unload_all()
        th.join(timeout=30)


def _image_chat_served(base, body, load):
    """/loadmodel, the chat, /unloadmodel on a server: (text, completion
    tokens, prompt tokens)."""
    status, resp = _post(base, "/loadmodel", load)
    assert status == 200, resp
    status, resp = _post(base, "/v1/chat/completions", body)
    assert status == 200, resp
    status, _ = _post(base, "/unloadmodel", {"model": load["model"]})
    assert status == 200
    usage = resp["usage"]
    return (resp["choices"][0]["message"]["content"],
            usage["completion_tokens"], usage["prompt_tokens"])


def test_grid_backend_refused_before_any_process(path, tmp_path,
                                                 monkeypatch):
    """A backend the devices cannot run is refused before any process
    starts. An mmproj, refused on a grid before, is served: a tiny
    LLaVA-1.5 image chat (its 16 image rows one unbucketed chunk on every
    rank) at tensor_parallel 2 and data_parallel 2 gives the port's 1x1
    load's text and usage, and the JAX registry's at the same grid (its
    warm-up compile skipped), with no process left after /unloadmodel."""
    import base64

    from tests.test_clip import _png_bytes, tiny_hf_clip, write_mmproj
    from tpu_engine.api.server import make_server as jax_make_server
    from tpu_engine.serve.engine import InferenceEngine as JEngine
    from tpu_engine_torch.api.server import make_server
    from tpu_engine_torch.serve.registry import EngineRegistry

    reg = EngineRegistry(device="cpu", devices=["cpu"] * 2, backend="nccl")
    ok, msg = reg.load_model({"llama_model_path": path, "model": "m",
                              "tensor_parallel": 2})
    assert not ok and "nccl needs a CUDA device per rank" in msg
    assert multiprocessing.active_children() == []

    monkeypatch.setenv("TPU_ENGINE_DECODE_CHUNK", "8")
    monkeypatch.setenv("TPU_ENGINE_BF16_SCALES", "0")
    monkeypatch.setattr(JEngine, "warm_up", lambda self, *a, **kw: None)
    mm = write_mmproj(str(tmp_path / "m15.gguf"), tiny_hf_clip(),
                      e_llm=load_model(path, device="cpu").cfg.n_embd)[0]
    png = _png_bytes(seed=5, size=(48, 40))
    body = {"model": "mm", "max_tokens": 8, "temperature": 0,
            "messages": [{"role": "user", "content": [
                {"type": "text", "text": "what is this?"},
                {"type": "image_url", "image_url": {
                    "url": "data:image/png;base64,"
                           + base64.b64encode(png).decode()}}]}]}
    load = {"llama_model_path": path, "model": "mm", "mmproj": mm,
            "n_parallel": 2, "n_batch": 16}
    grids = ({"tensor_parallel": 2}, {"data_parallel": 2})
    got, want = {}, {}
    for make, out, runs in (
            (lambda port: make_server("127.0.0.1", port, device="cpu",
                                      devices=["cpu"] * 2), got,
             ({},) + grids),
            (lambda port: jax_make_server("127.0.0.1", port), want, grids)):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        srv = make(port)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            for grid in runs:
                out[json.dumps(grid)] = _image_chat_served(
                    f"http://127.0.0.1:{port}", body, {**load, **grid})
                assert multiprocessing.active_children() == []
        finally:
            srv.shutdown()
            srv.server_close()
            srv.registry.unload_all()
            th.join(timeout=30)
    one = got.pop("{}")
    assert one[1] > 0 and one[2] > 16  # 16 image tokens in the prompt
    assert got == want and set(got.values()) == {one}, (got, want, one)
