"""Tensor and data parallelism of the port (tpu_engine_torch/dist/tp.py)
against its one-rank path and the JAX package's dist/tp.py, on the JAX
tests' model (tests/test_tp.py: 8 heads, 4 kv heads, hidden 256).

The port's ranks are spawned processes on the CPU over gloo
(tests/torch_dist_workers.py); the JAX side runs make_tp_functions on
the virtual CPU devices, with f32 scale storage (TPU_ENGINE_BF16_SCALES
=0) as the port keeps. Tolerances are tests/test_tp.py's (rtol 2e-4,
atol 2e-3):

  - TP forward (prefill + one step) at p = 2 and 4 against the port's
    one-rank forward and the JAX package's TP forward at the same p
    (f32, q8_0, q4_k_m);
  - greedy decode_loop at p = 4: the tokens of the JAX decode_loop;
  - the engine serving four greedy requests at p = 4, and on DP grids
    (2, 1) and (2, 2) also at temperature 0.8 with one sampler seed: the
    unsharded engine's texts;
  - the DP decode_loop: each rank's cache holds S/dp slots, the tokens
    (greedy and at temperature 0.8) are the one-rank loop's;
  - validate_tp and the registry's refusals in the JAX package's words;
  - a phi3 GGUF (q|k|v and gate|up stored fused) at TP=2: each rank's
    parts are the JAX sharder's bytes, its logits and greedy text the JAX
    TP=2 load's;
  - a fused q|k|v of a rank's slice splits by the rank's heads;
  - a 1x1 mesh through make_tp_functions gives the plain path's bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.models import build_test_gguf
from tests.torch_dist_workers import (PROMPT, leader_follower, run_group,
                                      serve_prompts, tp_decode, tp_forward)
from tpu_engine.dist import tp as JT
from tpu_engine.kvcache.cache import new_cache as j_cache
from tpu_engine.model.llama import decode_loop as j_loop
from tpu_engine.model.llama import forward_step as j_fwd
from tpu_engine.model.loader import load_model as j_load
from tpu_engine.sampling import SamplingParams as JSP
from tpu_engine.sampling.device import new_state as j_state
from tpu_engine.sampling.device import params_from_host as j_params
from tpu_engine_torch.dist import sharding as TS
from tpu_engine_torch.dist import tp as TT
from tpu_engine_torch.kvcache.cache import new_cache as t_cache
from tpu_engine_torch.model.llama import decode_loop as t_loop
from tpu_engine_torch.model.llama import forward_step as t_fwd
from tpu_engine_torch.model.loader import load_model as t_load
from tpu_engine_torch.model.weights import QTensor
from tpu_engine_torch.sampling import SamplingParams
from tpu_engine_torch.sampling.device import new_state, params_from_host

torch.set_num_threads(2)

QUANTS = ["f32", "q8_0", "q4_k_m"]
TOL = dict(rtol=2e-4, atol=2e-3)
PROMPTS = [[1, 30 + i, 40 + i, 50] for i in range(4)]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_models")
    return {q: build_test_gguf(str(d / f"m-{q}.gguf"), q, seed=9, n_heads=8,
                               n_kv_heads=4, hidden_size=256,
                               intermediate_size=256) for q in QUANTS}


@pytest.fixture(scope="module")
def tp_logits(paths, tmp_path_factory):
    """{p: {quant: (prefill, step)}} from the port's ranks (rank 0's)."""
    d = tmp_path_factory.mktemp("tp_groups")
    out = {}
    for p in (2, 4):
        got = run_group(tp_forward, p, str(d / f"p{p}"), list(paths.values()))
        # every rank holds the same gathered logits
        for other in got[1:]:
            for q in paths.values():
                assert all(torch.equal(a, b) for a, b in zip(got[0][q], other[q]))
        out[p] = {q: got[0][paths[q]] for q in QUANTS}
    return out


def _t(a, dtype=torch.int32):
    return torch.tensor(a, dtype=dtype)


def _port_ref(path):
    lm = t_load(path, device="cpu")
    cfg = lm.cfg
    cache = t_cache(cfg.n_layer, 2, 32, cfg.n_kv_head, cfg.head_dim,
                    device="cpu")
    pre, cache, _ = t_fwd(lm.weights, cache, _t([PROMPT]), _t([0]),
                          _t([True], torch.bool), cfg)
    step, _, _ = t_fwd(lm.weights, cache, _t([[50], [60]]), _t([0, 1]),
                       _t([True, True], torch.bool), cfg)
    return lm, pre, step


def _jax_tp(path, p):
    mesh = JT.tp_mesh(p)
    lm = j_load(path, sharder=JT.TPSharder(mesh))
    cfg = lm.cfg
    fwd, _ = JT.make_tp_functions(mesh, lm.weights, cfg)
    cache = JT.shard_cache_tp(
        j_cache(cfg.n_layer, 2, 32, cfg.n_kv_head, cfg.head_dim), mesh)
    pre, cache, _ = fwd(lm.weights, cache, jnp.asarray([PROMPT], jnp.int32),
                        jnp.asarray([0], jnp.int32), jnp.asarray([True]), cfg)
    step, _, _ = fwd(lm.weights, cache, jnp.asarray([[50], [60]], jnp.int32),
                     jnp.asarray([0, 1], jnp.int32),
                     jnp.asarray([True, True]), cfg)
    return np.asarray(pre), np.asarray(step)


@pytest.mark.parametrize("quant", QUANTS)
def test_tp_forward_matches_one_rank_and_jax(paths, tp_logits, quant,
                                             monkeypatch):
    monkeypatch.setenv("TPU_ENGINE_BF16_SCALES", "0")
    _, ref_pre, ref_step = _port_ref(paths[quant])
    for p in (2, 4):
        pre, step = tp_logits[p][quant]
        assert pre.shape == ref_pre.shape and step.shape == ref_step.shape
        np.testing.assert_allclose(pre.numpy(), ref_pre.numpy(), **TOL)
        np.testing.assert_allclose(step.numpy(), ref_step.numpy(), **TOL)
        j_pre, j_step = _jax_tp(paths[quant], p)
        np.testing.assert_allclose(pre.numpy(), j_pre, **TOL)
        np.testing.assert_allclose(step.numpy(), j_step, **TOL)


def test_tp_decode_loop_token_parity(paths, tmp_path):
    """p = 4, greedy: the JAX package's one-device decode_loop tokens."""
    path = paths["q4_k_m"]
    got = run_group(tp_decode, 4, str(tmp_path), path)
    lm = j_load(path)
    cfg = lm.cfg
    S = 2
    cache = j_cache(cfg.n_layer, S, 64, cfg.n_kv_head, cfg.head_dim)
    _, cache, _ = j_fwd(lm.weights, cache, jnp.asarray([PROMPT] * S, jnp.int32),
                        jnp.arange(S, dtype=jnp.int32), jnp.ones((S,), bool),
                        cfg)
    toks, last, _, _ = j_loop(
        lm.weights, cache, jnp.asarray([5, 6], jnp.int32), jnp.ones((S,), bool),
        cfg, j_params([JSP(temperature=0.0)] * S), j_state(S, seed=7), 8)
    for g in got:
        assert g["local_heads"] == cfg.n_kv_head // 4
        np.testing.assert_array_equal(g["toks"].numpy(), np.asarray(toks))
        np.testing.assert_array_equal(g["last"].numpy(), np.asarray(last))


def _one_rank_loop(path, S, temp):
    lm = t_load(path, device="cpu")
    cfg = lm.cfg
    cache = t_cache(cfg.n_layer, S, 64, cfg.n_kv_head, cfg.head_dim,
                    device="cpu")
    _, cache, _ = t_fwd(lm.weights, cache, _t([PROMPT] * S),
                        torch.arange(S, dtype=torch.int32),
                        torch.ones((S,), dtype=torch.bool), cfg)
    params = params_from_host([SamplingParams(temperature=temp)] * S,
                              device="cpu")
    toks, _, cache, _ = t_loop(lm.weights, cache,
                               _t([5 + i for i in range(S)]),
                               torch.ones((S,), dtype=torch.bool), cfg, params,
                               new_state(S, seed=7, device="cpu"), 8)
    return toks, cache.lengths


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_dp_decode_loop_slots_sharded(paths, tmp_path, temp):
    """(2, 1) grid, S = 4: each rank's cache holds 2 slots; every rank
    returns all 4 slots' tokens, the one-rank loop's (at temperature 0.8
    too: each rank draws every slot's noise and keeps its rows)."""
    path = paths["q8_0"]
    got = run_group(tp_decode, 2, str(tmp_path), path, 2, temp)
    ref, ref_len = _one_rank_loop(path, 4, temp)
    for d, g in enumerate(got):
        assert g["local_slots"] == 2 and g["toks"].shape == (4, 8)
        assert torch.equal(g["toks"], ref)
        assert torch.equal(g["lengths"], ref_len[2 * d:2 * d + 2])
        assert g["lengths"].tolist() == [len(PROMPT) + 8] * 2


def _engine_texts(path, rounds, seed):
    from tpu_engine_torch.serve import InferenceEngine

    eng = InferenceEngine(t_load(path, device="cpu"), n_ctx=256, n_parallel=4,
                          prefill_buckets=(16,), decode_chunk=4)
    eng._dev_seed = seed
    try:
        return [serve_prompts(eng, PROMPTS, temp) for temp in rounds]
    finally:
        eng.shutdown()


@pytest.mark.parametrize("n_data,n_model,rounds", [
    (1, 4, (0.0,)), (2, 1, (0.0, 0.8)), (2, 2, (0.0, 0.8))])
def test_grid_engine_generates_same_texts(paths, tmp_path, n_data, n_model,
                                          rounds):
    """dist/multihost: rank 0's engine plus followers on an n_data x
    n_model grid serve the unsharded engine's texts (one sampler seed)."""
    path = paths["q4_k_m"]
    ref = _engine_texts(path, rounds, seed=11)
    got = run_group(leader_follower, n_data * n_model, str(tmp_path), path,
                    n_data, PROMPTS, rounds, 11)
    texts, ok, state = got[0]
    assert ok, "the ranks' state diverged"
    assert state["steps_equal"]
    assert texts == ref


def test_validate_tp_refusals_match_jax(paths):
    """A model loaded whole fails validate_tp; head counts that do not
    divide fail with the JAX package's message."""
    path = paths["q8_0"]
    lm = t_load(path, device="cpu")
    with pytest.raises(ValueError, match="perm_shards|unfused"):
        TT.validate_tp(lm.cfg, lm.weights, 4)
    jm = j_load(path)
    for p in (3, 8):
        with pytest.raises(ValueError) as te:
            TT.validate_tp(lm.cfg, lm.weights, p)
        with pytest.raises(ValueError) as je:
            JT.validate_tp(jm.cfg, jm.weights, p)
        assert str(te.value) == str(je.value)
    TT.validate_tp(lm.cfg, lm.weights, 1)  # dp-only: nothing to split
    w2 = TS.shard_weights(lm.weights, lm.cfg, 2, 0)
    TT.validate_tp(lm.cfg, w2, 2)
    with pytest.raises(ValueError, match="perm_shards=2, need 4"):
        TT.validate_tp(lm.cfg, w2, 4)


def test_registry_refusals_match_jax(paths):
    """The refusals of a grid that cannot be served, word for word the
    JAX registry's (8 devices on both sides)."""
    from tpu_engine.serve.registry import EngineRegistry as JReg
    from tpu_engine_torch.serve.registry import EngineRegistry as TReg

    path = paths["q4_k_m"]
    treg, jreg = TReg(device="cpu", devices=["cpu"] * 8), JReg()
    for extra in ({"tensor_parallel": 16},
                  {"tensor_parallel": 2, "data_parallel": 2, "n_parallel": 3},
                  {"tensor_parallel": 8},
                  {"tensor_parallel": "auto", "data_parallel": 16}):
        body = {"llama_model_path": path, "model": "m", "ctx_len": 256,
                "n_parallel": 4, **extra}
        got, want = treg.load_model(dict(body)), jreg.load_model(dict(body))
        assert not got[0] and got == want, (extra, got, want)


def test_tp_fused_qkv_splits_by_the_rank_heads(paths):
    """A rank's fused q|k|v (shard_weights fuses the rank's slices) gives
    the forward of the same slices held unfused: the split follows the
    tensor's width, not the model's head count."""
    lm = t_load(paths["f32"], device="cpu")
    cfg = lm.cfg
    assert "wqkv" in lm.weights["layers"][0]
    for r in range(2):
        fused = TS.shard_weights(lm.weights, cfg, 2, r)
        unfused = dict(fused, layers=[])
        for lw in fused["layers"]:
            qkv = lw["wqkv"]
            n_q = qkv.shape[0] * cfg.n_head // (cfg.n_head + 2 * cfg.n_kv_head)
            n_kv = (qkv.shape[0] - n_q) // 2
            nl = {k: v for k, v in lw.items() if k != "wqkv"}
            for key, a, b in (("wq", 0, n_q), ("wk", n_q, n_q + n_kv),
                              ("wv", n_q + n_kv, n_q + 2 * n_kv)):
                nl[key] = TS.slice_rows(qkv, a, b)
            unfused["layers"].append(nl)
        assert n_q == cfg.n_head // 2 * cfg.head_dim
        outs = []
        for w in (fused, unfused):
            cache = t_cache(cfg.n_layer, 1, 32, cfg.n_kv_head // 2,
                            cfg.head_dim, device="cpu")
            lg, _, _ = t_fwd(w, cache, _t([PROMPT]), _t([0]),
                             _t([True], torch.bool), cfg)
            outs.append(lg)
        assert torch.equal(outs[0], outs[1])


def test_one_by_one_mesh_matches_plain(paths):
    """An explicit 1x1 mesh routes through make_tp_functions (no group):
    the plain forward's bits, and the plain engine's texts."""
    from tpu_engine_torch.serve import InferenceEngine

    path = paths["q4_k_m"]
    lm, pre, step = _port_ref(path)
    mesh = TT.tp_mesh(1, devices=["cpu"])
    assert (mesh.n_data, mesh.n_model, mesh.model_group) == (1, 1, None)
    fwd, _ = TT.make_tp_functions(mesh, lm.weights, lm.cfg)
    cfg = lm.cfg
    cache = TT.shard_cache_tp(t_cache(cfg.n_layer, 2, 32, cfg.n_kv_head,
                                      cfg.head_dim, device="meta"), mesh)
    p2, cache, _ = fwd(lm.weights, cache, _t([PROMPT]), _t([0]),
                       _t([True], torch.bool), cfg)
    s2, _, _ = fwd(lm.weights, cache, _t([[50], [60]]), _t([0, 1]),
                   _t([True, True], torch.bool), cfg)
    assert torch.equal(p2, pre) and torch.equal(s2, step)
    eng = InferenceEngine(t_load(path, device="cpu"), n_ctx=256, n_parallel=4,
                          prefill_buckets=(16,), decode_chunk=4, mesh=mesh)
    try:
        texts = serve_prompts(eng, PROMPTS)
    finally:
        eng.shutdown()
    assert texts == _engine_texts(path, (0.0,), seed=0)[0]


def test_nccl_on_a_repeated_device_is_refused():
    TT.check_backend("gloo", ["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="cuda:0 repeats"):
        TT.check_backend("nccl", ["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="CUDA device per rank"):
        TT.check_backend("nccl", ["cpu", "cpu"])
    assert TT.default_backend(["cpu", "cpu"]) == "gloo"
    assert TT.default_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert isinstance(TS.shard_qtensor(
        QTensor(qs=torch.zeros((4, 8)), scale=None, bias=None, kind="dense",
                group=0, shape=(4, 8)), "wq", 2, 1), QTensor)


def _jax_rank_rows(qt, spec, li: int, mesh, r: int):
    """Layer li of a stacked JAX QTensor, cut as the JAX TP forward's
    shard_map hands it to rank r (its weight spec, dist/tp._weight_specs),
    as a plain mapping for the port's _qt_from_mapping."""
    from jax.sharding import NamedSharding

    dev = np.asarray(mesh.devices).reshape(-1)[r]
    out = {}
    for key in ("qs", "scale", "bias"):
        a = getattr(qt, key)
        if a is None:
            out[key] = None
            continue
        idx = NamedSharding(mesh, spec).devices_indices_map(a.shape)[dev]
        out[key] = np.asarray(a)[idx][li]
    n = out["qs"].shape[0]
    return dict(out, kind=qt.kind, group=qt.group, shape=(n, qt.shape[1]),
                perm=qt.perm, perm_shards=qt.perm_shards, packed=qt.packed,
                k_pad=qt.k_pad)


def test_stored_fused_projections_refused_under_tp(tmp_path, monkeypatch):
    """phi3 stores q|k|v and gate|up fused. Under TP the port's loader now
    cuts them back into their parts by rows and shards each part, as the
    JAX loader does (before, it kept them whole and the registry and
    validate_tp refused them; this test failed there). At f32 and q8_0:
    each TP=2 rank's wq, wk, wv, w_gate and w_up (sliced out of the
    rank's fused q|k|v and gate|up) hold the bytes of the rank's shard in
    the JAX TP forward (its weight specs), and validate_tp passes; the port's TP=2 ranks'
    prefill and step logits are the JAX TP=2 forward's and the port's
    one-rank forward's within TOL; the port's registry serves the file at
    tensor_parallel 2 with the JAX registry's greedy text (its warm-up
    compile skipped) and the 1x1 load's."""
    from tests.models import tokenizer_metadata
    from tests.test_archs import VOCAB, tiny_phi3
    from tpu_engine.serve.engine import InferenceEngine as JEngine
    from tpu_engine.serve.registry import EngineRegistry as JReg
    from tpu_engine.serve.types import CompletionParams as JCP
    from tpu_engine.tools.convert import hf_llama_to_gguf
    from tpu_engine_torch.model.weights import _qt_from_mapping
    from tpu_engine_torch.serve import CompletionParams
    from tpu_engine_torch.serve.registry import EngineRegistry

    monkeypatch.setenv("TPU_ENGINE_BF16_SCALES", "0")
    monkeypatch.setenv("TPU_ENGINE_DECODE_CHUNK", "8")
    monkeypatch.setattr(JEngine, "warm_up", lambda self, *a, **kw: None)
    paths = {}
    for quant in ("f32", "q8_0"):
        paths[quant] = str(tmp_path / f"phi3-{quant}.gguf")
        hf_llama_to_gguf(tiny_phi3(), paths[quant], quant,
                         tokenizer_metadata(VOCAB), name="phi3")
    logits = run_group(tp_forward, 2, str(tmp_path / "tp2"),
                       list(paths.values()))[0]
    for quant, path in paths.items():
        jmesh = JT.tp_mesh(2)
        jm = j_load(path, sharder=JT.TPSharder(jmesh))
        specs = JT._weight_specs(jm.weights, 2)["layers"]
        H, KH, D = jm.cfg.n_head, jm.cfg.n_kv_head, jm.cfg.head_dim
        for r in range(2):
            lm = t_load(path, device="cpu", sharder=TS.make_sharder(2, r))
            TT.validate_tp(lm.cfg, lm.weights, 2)
            for li, lw in enumerate(lm.weights["layers"]):
                qkv, gu = lw["wqkv"], lw["w_gateup"]
                nq, nkv = H * D // 2, KH * D // 2
                parts = {"wq": TS.slice_rows(qkv, 0, nq),
                         "wk": TS.slice_rows(qkv, nq, nq + nkv),
                         "wv": TS.slice_rows(qkv, nq + nkv, nq + 2 * nkv),
                         "w_gate": TS.slice_rows(gu, 0, gu.shape[0] // 2),
                         "w_up": TS.slice_rows(gu, gu.shape[0] // 2,
                                               gu.shape[0])}
                assert qkv.shape[0] == nq + 2 * nkv
                assert gu.shape[0] == lm.cfg.n_ff
                for key, got in parts.items():
                    want = _qt_from_mapping(_jax_rank_rows(
                        jm.weights["layers"][key], specs[key], li, jmesh,
                        r), "cpu")
                    assert want.shape == got.shape, (quant, key)
                    for a, b in ((got.qs, want.qs), (got.scale, want.scale),
                                 (got.bias, want.bias)):
                        assert (a is None) == (b is None)
                        if a is not None:
                            assert torch.equal(a, b), (quant, r, li, key)
        pre, step = logits[path]
        _, ref_pre, ref_step = _port_ref(path)
        j_pre, j_step = _jax_tp(path, 2)
        for got, want in ((pre, j_pre), (step, j_step), (pre, ref_pre.numpy()),
                          (step, ref_step.numpy())):
            np.testing.assert_allclose(got.numpy(), want, **TOL)

    def text(reg, params, grid):
        ok, msg = reg.load_model({"llama_model_path": paths["q8_0"],
                                  "model": "p", "ctx_len": 128,
                                  "n_parallel": 2, **grid})
        assert ok, msg
        try:
            eng = reg.get("p").engine
            tid = eng.request_completion(params)
            while True:
                res = eng.next_result(tid, timeout=300.0)
                assert not res.error, res.error_message
                if res.stop:
                    return res.text
        finally:
            reg.unload_all()

    texts = []
    for grid in ({}, {"tensor_parallel": 2}):
        texts.append(text(EngineRegistry(device="cpu", devices=["cpu"] * 2),
                          CompletionParams(prompt=PROMPT, n_predict=12,
                                           sampling=SamplingParams(
                                               temperature=0.0)), grid))
    texts.append(text(JReg(), JCP(prompt=PROMPT, n_predict=12,
                                  sampling=JSP(temperature=0.0)),
                      {"tensor_parallel": 2}))
    assert texts[0] == texts[1] == texts[2] and texts[0]
