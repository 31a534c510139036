"""The port's embedding-model path (tpu_engine_torch model/bert.py,
model/loader.py's encoder branch, serve/encoder.py, the registry's
non-causal branch and /v1/embeddings) against the JAX package, mirroring
tests/test_bert.py.

The same GGUF goes through both packages: a tiny HF BertModel converted
by the JAX package's hf_bert_to_gguf, and a tiny nomic-bert written by
the port's tools/encoder_gguf.py (E=256, F=512, so K quantizes). Both
run on the CPU, where the port's quantized products are qmatmul_plain
(f32 dequant + matmul, the JAX package's XLA path). The JAX package
stores k-quant and Q8_0 scales as bf16 by default; these tests turn that
off (TPU_ENGINE_BF16_SCALES=0), so the two hold the same weights. Pooled
vectors agree within 1e-5 of max |v| at f32 and 1e-4 of max |v| at Q8_0,
Q4_K (level q4_k_s) and the Q4_K_M mix (level q4_k_m, nomic-bert): both
packages compute in f32 and differ only in sum order (about 3e-7).
"""

import json
import socket
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.models import build_test_gguf
from tests.test_bert import WP_VOCAB, tiny_bert, wp_tokenizer_metadata
from tpu_engine.model.bert import encode as j_encode
from tpu_engine.model.loader import load_model as j_load
from tpu_engine.tokenizer.tokenizer import Tokenizer as JTok
from tpu_engine.tools.convert import hf_bert_to_gguf
from tpu_engine_torch.model.bert import encode as t_encode
from tpu_engine_torch.model.loader import load_model as t_load
from tpu_engine_torch.model.weights import QTensor, from_jax_params
from tpu_engine_torch.tokenizer.tokenizer import Tokenizer as TTok
from tpu_engine_torch.tools.encoder_gguf import (build_nomic_bert_gguf,
                                                 wordpiece_metadata)

torch.set_num_threads(2)

POOLING = {"mean": 1, "cls": 2, "last": 3}
TOL = {"f32": 1e-5, "q8_0": 1e-4, "q4_k_s": 1e-4, "q4_k_m": 1e-4}
NOMIC = (2, 256, 4, 512, len(WP_VOCAB), 128)  # L, E, H, F, V, n_ctx_train


@pytest.fixture(autouse=True)
def f32_scales(monkeypatch):
    monkeypatch.setenv("TPU_ENGINE_BF16_SCALES", "0")


def wide_bert(seed=29):
    """tiny_bert's config at E=256, F=512, so every projection's K is a
    multiple of 256 and quantizes."""
    from transformers import BertConfig, BertModel

    torch.manual_seed(seed)
    cfg = BertConfig(
        vocab_size=len(WP_VOCAB), hidden_size=256, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=512,
        max_position_embeddings=64, type_vocab_size=2,
        layer_norm_eps=1e-12, attn_implementation="eager")
    return BertModel(cfg).eval()


class Models:
    """GGUFs of this module, each written once: bert (tiny_bert at f32,
    wide_bert at a quantized level) with a pooling type, and nomic-bert.
    Levels: f32, q8_0, q4_k_s (every projection Q4_K) and, for nomic-bert,
    q4_k_m (the mix)."""

    def __init__(self, d):
        self.d, self.paths = d, {}

    def bert(self, level, pooling="mean"):
        key = ("bert", level, pooling)
        if key not in self.paths:
            hf = tiny_bert() if level == "f32" else wide_bert()
            p = str(self.d / f"bert_{level}_{pooling}.gguf")
            hf_bert_to_gguf(hf, p, level, wp_tokenizer_metadata(),
                            pooling_type=POOLING[pooling])
            self.paths[key] = p
        return self.paths[key]

    def nomic(self, level):
        key = ("nomic", level)
        if key not in self.paths:
            p = str(self.d / f"nomic_{level}.gguf")
            build_nomic_bert_gguf(p, level=level, widths=NOMIC, seed=4)
            self.paths[key] = p
        return self.paths[key]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return Models(tmp_path_factory.mktemp("enc"))


TOKS = np.array([[2, 5, 6, 7, 8, 13, 14, 15, 3, 0, 0, 0, 0, 0, 0, 0],
                 [2, 19, 22, 20, 23, 30, 31, 40, 41, 42, 50, 60, 61, 62, 63, 3]],
                np.int32)
NV = np.array([9, 16], np.int32)


def both_encodes(path, pooling=""):
    jl, tl = j_load(path), t_load(path, device="cpu")
    ref = np.asarray(j_encode(jl.weights, jnp.asarray(TOKS), jnp.asarray(NV),
                              jl.cfg, pooling))
    got = t_encode(tl.weights, torch.from_numpy(TOKS), torch.from_numpy(NV),
                   tl.cfg, pooling).numpy()
    return ref, got, tl


@pytest.mark.parametrize("level", ["f32", "q8_0", "q4_k_s"])
@pytest.mark.parametrize("pooling", ["mean", "cls", "last"])
def test_bert_encode_matches_jax(models, pooling, level):
    """bert at each pooling type (the GGUF's own) and level: the port's
    encode of a padded two-row batch against the JAX package's."""
    ref, got, tl = both_encodes(models.bert(level, pooling))
    assert tl.cfg.arch == "bert" and tl.cfg.pooling_type == pooling
    kinds = {v.kind for v in tl.weights["layers"][0].values()
             if isinstance(v, QTensor)}
    assert kinds == {{"f32": "dense", "q8_0": "i8", "q4_k_s": "nib4"}[level]}
    assert got.shape == ref.shape == (2, tl.cfg.n_embd) and got.dtype == np.float32
    assert np.abs(got - ref).max() <= TOL[level] * np.abs(ref).max()


@pytest.mark.parametrize("level", ["f32", "q8_0", "q4_k_s", "q4_k_m"])
def test_nomic_bert_encode_matches_jax(models, level):
    """nomic-bert (rope, SwiGLU, no projection biases, mean pooling) at f32,
    Q8_0, Q4_K and the Q4_K_M mix (Q6_K attn_v/ffn_down on llama.cpp's
    use_more_bits layers), at every pooling mode."""
    path = models.nomic(level)
    for pooling in ("", "cls", "last"):
        ref, got, tl = both_encodes(path, pooling)
        assert np.abs(got - ref).max() <= TOL[level] * np.abs(ref).max()
    assert tl.cfg.arch == "nomic-bert" and tl.cfg.pooling_type == "mean"
    lw = tl.weights["layers"]
    assert "w_gate" in lw[0] and "position_embd" not in tl.weights
    assert not any(k.endswith("_b") and k[:-2] in ("wq", "wk", "wv")
                   for k in lw[0])
    if level == "q4_k_m":
        # at L=2 use_more_bits holds for layer 1 only
        assert lw[0]["wv"].kind == lw[0]["w_down"].kind == "nib4"
        assert lw[1]["wv"].kind == lw[1]["w_down"].kind == "i8"
        assert lw[1]["wq"].kind == lw[1]["w_up"].kind == "nib4"


def test_padding_does_not_reach_valid_rows(models):
    """Only keys are masked: a row's vector does not depend on its padding
    length, and a padded query row still attends (no NaN anywhere)."""
    tl = t_load(models.nomic("f32"), device="cpu")
    ids = torch.from_numpy(TOKS[:1, :9])
    short = t_encode(tl.weights, ids, torch.tensor([9]), tl.cfg)
    long = t_encode(tl.weights, torch.from_numpy(TOKS[:1]), torch.tensor([9]),
                    tl.cfg)
    np.testing.assert_allclose(long.numpy(), short.numpy(), rtol=1e-5, atol=1e-6)
    assert torch.isfinite(long).all()


def _plain(tree):
    """The JAX package's weights as numpy arrays and QTensor mappings (the
    form from_jax_params takes)."""
    from tpu_engine.model.weights import QTensor as JQ

    if isinstance(tree, JQ):
        return dict(qs=np.asarray(tree.qs), kind=tree.kind, group=tree.group,
                    scale=None if tree.scale is None else np.asarray(tree.scale),
                    bias=None if tree.bias is None else np.asarray(tree.bias),
                    shape=tree.shape, perm=tree.perm,
                    perm_shards=tree.perm_shards, packed=tree.packed,
                    k_pad=tree.k_pad)
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    return np.asarray(tree)


def _assert_same(a, b):
    if isinstance(a, QTensor):
        assert (a.kind, a.group, a.shape) == (b.kind, b.group, b.shape)
        for name in ("qs", "scale", "bias"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None)
            if x is not None:
                assert x.dtype == y.dtype and torch.equal(x, y), name
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("which", ["bert-q8_0", "bert-f32", "nomic-q4_k_m"])
def test_from_jax_params_equals_port_loader(models, which):
    """An encoder's JAX weights (per-layer list, *_b biases, token_types,
    position_embd, token_embd_norm_b, no output) carried across equal the
    port's load_model of the same GGUF, leaf for leaf and bit for bit."""
    kind, level = which.split("-")
    path = models.bert(level) if kind == "bert" else models.nomic(level)
    jl, tl = j_load(path), t_load(path, device="cpu")
    carried = from_jax_params(_plain(jl.weights), jl.cfg, "cpu")
    assert set(carried) == set(tl.weights) and "output" not in carried
    for key, v in tl.weights.items():
        if key != "layers":
            _assert_same(v, carried[key])
    assert len(carried["layers"]) == len(tl.weights["layers"])
    for lc, lt in zip(carried["layers"], tl.weights["layers"]):
        assert set(lc) == set(lt)
        for key in lt:
            _assert_same(lt[key], lc[key])
    a = t_encode(carried, torch.from_numpy(TOKS), torch.from_numpy(NV), tl.cfg)
    b = t_encode(tl.weights, torch.from_numpy(TOKS), torch.from_numpy(NV), tl.cfg)
    assert torch.equal(a, b)


TEXTS = ["the quick brown fox jumps over the lazy dog", "Unbreakable!",
         "hello, world.", "café hello", "zzz unknown zzz", "  spaced   out  ",
         ""]


@pytest.mark.parametrize("text", TEXTS)
def test_wordpiece_matches_jax(text):
    """The port's WordPiece tokenizer equals the JAX one, on the test
    vocabulary and on tools/encoder_gguf.py's made-up one."""
    for md in (wp_tokenizer_metadata(), wordpiece_metadata(30522)):
        jt, tt = JTok.from_gguf_metadata(md), TTok.from_gguf_metadata(md)
        for special in (True, False):
            assert (tt.encode(text, add_special=special)
                    == jt.encode(text, add_special=special))
        assert tt.bos_id == jt.bos_id and tt.eos_id == jt.eos_id


def test_encoder_config_matches_jax(models):
    """The port's _encoder_from_gguf gives the JAX package's config for
    bert and nomic-bert."""
    import dataclasses

    for path in (models.bert("f32", "cls"), models.nomic("f32")):
        jc, tc = j_load(path).cfg, t_load(path, device="cpu").cfg
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert not tc.causal


def _engines(path, n_ctx):
    from tpu_engine.serve.encoder import EncoderEngine as JE
    from tpu_engine_torch.serve.encoder import EncoderEngine as TE

    return JE(j_load(path), n_ctx=n_ctx), TE(t_load(path, device="cpu"),
                                             n_ctx=n_ctx)


def test_encoder_engine_matches_jax(models, monkeypatch):
    """EncoderEngine against the JAX EncoderEngine on the same f32 bert
    (n_ctx 48: not a power of two, below n_ctx_train 64): the same bucket
    lengths, truncation at n_ctx, the empty prompt as [bos], unit-norm
    vectors within 1e-5, prompt_n timings."""
    import tpu_engine.serve.encoder as JM
    import tpu_engine_torch.serve.encoder as TM
    from tpu_engine.serve.types import CompletionParams as JP
    from tpu_engine_torch.serve.types import CompletionParams as TP

    je, te = _engines(models.bert("f32"), 48)
    assert te.n_ctx == je.n_ctx == 48
    shapes = {"jax": [], "port": []}

    def spy(mod, key):
        real = mod.encode

        def f(w, toks, nv, cfg, *a, **kw):
            shapes[key].append((tuple(toks.shape), int(nv[0])))
            return real(w, toks, nv, cfg, *a, **kw)
        monkeypatch.setattr(mod, "encode", f)

    spy(JM, "jax")
    spy(TM, "port")
    rng = np.random.default_rng(1)
    prompts = ["the quick brown fox", [], [7], list(range(5, 13)),
               list(range(5, 14)), rng.integers(5, 64, 33).tolist(),
               rng.integers(5, 64, 70).tolist()]
    for prompt in prompts:
        jr = je.next_result(je.request_completion(JP(prompt=prompt,
                                                     embedding=True)))
        tr = te.next_result(te.request_completion(TP(prompt=prompt,
                                                     embedding=True)))
        assert not jr.error and not tr.error
        assert tr.tokens_evaluated == jr.tokens_evaluated
        assert tr.timings["prompt_n"] == jr.timings["prompt_n"]
        assert set(tr.timings) == {"prompt_n", "prompt_ms"}
        v, r = np.asarray(tr.embedding), np.asarray(jr.embedding)
        assert abs(np.linalg.norm(v) - 1.0) <= 1e-5
        assert np.abs(v - r).max() <= 1e-5
    assert shapes["port"] == shapes["jax"]
    # buckets: powers of two from 8, capped at n_ctx; the 70-token prompt
    # is cut to 48
    assert [s[0][1] for s in shapes["port"]] == [8, 8, 8, 8, 16, 48, 48]
    assert shapes["port"][1][1] == 1 and shapes["port"][-1][1] == 48
    # a request without `embedding` is refused with the JAX message
    jr = je.next_result(je.request_completion(JP(prompt="hi", n_predict=4)))
    tr = te.next_result(te.request_completion(TP(prompt="hi", n_predict=4)))
    assert tr.error and tr.error_message == jr.error_message
    assert "embedding" in tr.error_message
    assert te.n_requests == je.n_requests == len(prompts) + 1


def test_causal_embedding_matches_jax(tmp_path):
    """A causal GGUF loaded with model_type "embedding" is served by
    InferenceEngine's embedding path (no warm-up) in both registries:
    the same last-pooled vector, and the port's equals its own
    forward_step pooling (test_causal_pooling_last's check)."""
    from tpu_engine.serve.registry import EngineRegistry as JR
    from tpu_engine.serve.types import CompletionParams as JP
    from tpu_engine_torch.kvcache.cache import new_cache
    from tpu_engine_torch.model.llama import forward_step
    from tpu_engine_torch.serve.engine import InferenceEngine
    from tpu_engine_torch.serve.registry import EngineRegistry as TR
    from tpu_engine_torch.serve.types import CompletionParams as TP

    path = build_test_gguf(str(tmp_path / "m.gguf"), "f32", seed=5)
    body = {"llama_model_path": path, "model": "emb", "ctx_len": 128,
            "model_type": "embedding"}
    jr, tr = JR(), TR(device="cpu")
    vecs = []
    try:
        for reg, P in ((jr, JP), (tr, TP)):
            ok, msg = reg.load_model(dict(body))
            assert ok, msg
            entry = reg.get("emb")
            assert entry.opts["embedding"] and entry.opts["model_type"] == "embedding"
            eng = entry.engine
            r = eng.next_result(eng.request_completion(
                P(prompt="hello world test", embedding=True, n_predict=0)))
            assert not r.error
            vecs.append(np.asarray(r.embedding))
        assert isinstance(tr.get("emb").engine, InferenceEngine)
        np.testing.assert_allclose(vecs[1], vecs[0], rtol=1e-4, atol=1e-5)

        lm = tr.get("emb").model
        assert lm.cfg.pooling_type == "last"
        ids = lm.tokenizer.encode("hello world test")
        _, _, pooled = forward_step(
            lm.weights, new_cache(lm.cfg.n_layer, 1, 32, lm.cfg.n_kv_head,
                                  lm.cfg.head_dim, device="cpu"),
            torch.tensor([ids], dtype=torch.int32),
            torch.tensor([0], dtype=torch.int32), torch.tensor([True]),
            lm.cfg, collect_hidden="last")
        ref = pooled[0].numpy()
        np.testing.assert_allclose(vecs[1], ref / np.linalg.norm(ref),
                                   rtol=1e-4, atol=1e-5)
    finally:
        jr.unload_all()
        tr.unload_all()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _serve(make):
    port = _free_port()
    srv = make(port)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{port}"


def post(base, path, body, timeout=300.0):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


INPUTS = {
    "string": "the quick brown fox",
    "strings": ["hello world", "unbreakable dog", ""],
    "tokens": [2, 5, 6, 7, 8, 3],
    "token_lists": [[2, 19, 20, 3], [2, 5, 6, 7, 8, 13, 14, 15, 3]],
}


@pytest.fixture(scope="module")
def embed_twins(models):
    """The port's server (device cpu) and the JAX server, each with the
    same f32 bert loaded as model_type "embedding"."""
    from tpu_engine.api.server import make_server as jax_make_server
    from tpu_engine_torch.api.server import make_server

    path = models.bert("f32", "mean")
    srvs = [_serve(lambda port: make_server("127.0.0.1", port, device="cpu")),
            _serve(lambda port: jax_make_server("127.0.0.1", port))]
    for _, base in srvs:
        status, resp = post(base, "/loadmodel", {
            "model": "embed", "llama_model_path": path, "ctx_len": 64,
            "model_type": "embedding"})
        assert status == 200, resp
    yield [base for _, base in srvs]
    for srv, _ in srvs:
        srv.shutdown()
        srv.server_close()
        srv.registry.unload_all()


@pytest.mark.parametrize("form", sorted(INPUTS))
def test_embeddings_server_matches_jax(embed_twins, form):
    """/v1/embeddings on an EncoderEngine entry in every input form: the
    same number of unit vectors and usage as the JAX server, each within
    1e-5 of its vector."""
    outs = []
    for base in embed_twins:
        status, resp = post(base, "/v1/embeddings",
                            {"model": "embed", "input": INPUTS[form]})
        assert status == 200, resp
        outs.append(resp)
    port, ref = outs
    assert len(port["data"]) == len(ref["data"]) >= 1
    assert port["usage"] == ref["usage"]
    for a, b in zip(port["data"], ref["data"]):
        v, r = np.asarray(a["embedding"]), np.asarray(b["embedding"])
        assert a["index"] == b["index"] and v.shape == r.shape
        assert abs(np.linalg.norm(v) - 1.0) <= 1e-5
        assert np.abs(v - r).max() <= 1e-5


def test_embedding_model_refuses_chat_like_jax(embed_twins):
    """/v1/chat/completions against the embedding model: the JAX server's
    status and error; /modelstatus reports it loaded at n_ctx 64."""
    outs = [post(base, "/v1/chat/completions", {
        "model": "embed", "messages": [{"role": "user", "content": "hi"}]})
        for base in embed_twins]
    assert outs[0] == outs[1]
    assert outs[0][0] == 500 and "embeddings only" in outs[0][1]["error"]
    status = [post(base, "/modelstatus", {"model": "embed"})
              for base in embed_twins]
    assert status[0] == status[1] and status[0][0] == 200


def test_encode_trace_reads_device_activity(tmp_path):
    """tools/encode_trace.py's reading of a profiler trace: busy time is the
    union of device intervals (overlaps counted once, host ops ignored),
    split by kernel family."""
    from tpu_engine_torch.tools.encode_trace import device_activity

    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "void qmm_kernel<Cfg<I8>>",
         "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_f32f32",
         "ts": 5, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 30,
         "dur": 2},
        {"ph": "X", "cat": "kernel", "name": "vectorized_elementwise_kernel",
         "ts": 40, "dur": 3},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 100}]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(trace))
    busy, by_fam, n = device_activity(str(path))
    assert n == 4 and abs(busy - 0.020) < 1e-12
    assert by_fam == {"qmm": 0.010, "gemm (attention einsums)": 0.010,
                      "copy / set": 0.002, "elementwise and other": 0.003}


def test_encoder_engine_concurrent_requests(models):
    """Sixteen threads request at once (more than the cores, a short switch
    interval): each gets the vector of its own prompt, bit for bit the one
    a lone request gets, and every request is counted."""
    import sys

    from tpu_engine_torch.serve.encoder import EncoderEngine
    from tpu_engine_torch.serve.types import CompletionParams as TP

    te = EncoderEngine(t_load(models.nomic("q4_k_m"), device="cpu"), n_ctx=64)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(5, 64, int(n)).tolist()
               for n in rng.integers(1, 64, 16)]
    alone = [te.next_result(te.request_completion(
        TP(prompt=p, embedding=True))).embedding for p in prompts]
    got = [None] * len(prompts)

    def worker(i):
        got[i] = te.next_result(te.request_completion(
            TP(prompt=prompts[i], embedding=True)), timeout=120).embedding

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ths = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ths)
    assert got == alone and te.n_requests == 2 * len(prompts)
