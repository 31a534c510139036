"""The port's model (tpu_engine_torch.model: loader, forward_step,
decode_loop, from_jax_params) against the JAX package on small GGUFs.

  - f32 GGUF (tests/models.py): prefill and decode logits within 1e-4
    (both f32; only summation order differs, measured ~5e-7);
  - the same model carried across with from_jax_params (stacked [L, ...]
    leaves) gives the port's own loader's logits exactly;
  - Q4_K_M-mix GGUF (Q6_K output, attn_v and ffn_down on the
    use_more_bits layers; q|k|v unfused there): the JAX package stores
    scales as bf16 by default, the port as f32, so logits differ by the
    scale rounding (2^-9 relative): per-token KL below 1e-3 and top-1
    agreement on every token;
  - greedy decode_loop: the same 16 tokens as the JAX decode_loop at f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.models import build_test_gguf
from tpu_engine.kvcache.cache import default_layout as j_layout
from tpu_engine.kvcache.cache import dequant_kv as j_dequant
from tpu_engine.kvcache.cache import new_cache as j_cache
from tpu_engine.model.llama import decode_loop as j_loop
from tpu_engine.model.llama import forward_step as j_fwd
from tpu_engine.model.loader import load_model as j_load
from tpu_engine.sampling import SamplingParams
from tpu_engine.sampling import device as JS
from tpu_engine_torch.kvcache.cache import default_layout as t_layout
from tpu_engine_torch.kvcache.cache import new_cache as t_cache
from tpu_engine_torch.model.llama import decode_loop as t_loop
from tpu_engine_torch.model.llama import forward_step as t_fwd
from tpu_engine_torch.model.loader import load_model as t_load
from tpu_engine_torch.model.weights import QTensor, from_jax_params
from tpu_engine_torch.sampling import device as TS
from tpu_engine_torch.sampling.chain import SamplingParams as TSP
from tpu_engine_torch.tools.q4km import build_q4km_gguf

torch.set_num_threads(2)

PROMPT = [1, 270, 272, 274, 280, 300, 310, 320, 9, 77, 123]
FEED = [290, 291, 17, 305, 44, 281, 9, 333]


@pytest.fixture(scope="module")
def f32_path(tmp_path_factory):
    return build_test_gguf(str(tmp_path_factory.mktemp("m") / "f32.gguf"),
                           "f32", seed=3)


@pytest.fixture(scope="module")
def mix_path(tmp_path_factory):
    return build_q4km_gguf(str(tmp_path_factory.mktemp("m") / "mix.gguf"),
                           "tiny", n_layer=4, seed=2)


def run_jax(lm, kind="f16", feed=FEED, layout="td"):
    c = lm.cfg
    cache = j_cache(c.n_layer, 2, 64, c.n_kv_head, c.head_dim, kind=kind,
                    layout=layout)
    logits, cache, _ = j_fwd(lm.weights, cache, jnp.asarray([PROMPT], jnp.int32),
                             jnp.asarray([1], jnp.int32), jnp.asarray([True]), c,
                             rot_cache=True)
    rows = [np.asarray(logits)[0]]
    for t in feed:
        logits, cache, _ = j_fwd(lm.weights, cache, jnp.asarray([[t]], jnp.int32),
                                 jnp.asarray([1], jnp.int32), jnp.asarray([True]),
                                 c, rot_cache=True)
        rows.append(np.asarray(logits)[0])
    return np.stack(rows)


def run_port(weights, cfg, kind="f16", feed=FEED, layout="td"):
    cache = t_cache(cfg.n_layer, 2, 64, cfg.n_kv_head, cfg.head_dim, kind=kind,
                    layout=layout, device="cpu")
    one = torch.tensor([1], dtype=torch.int32)
    act = torch.tensor([True])
    logits, cache, _ = t_fwd(weights, cache, torch.tensor([PROMPT], dtype=torch.int32),
                             one, act, cfg, rot_cache=True)
    rows = [logits[0].numpy()]
    for t in feed:
        logits, cache, _ = t_fwd(weights, cache, torch.tensor([[t]], dtype=torch.int32),
                                 one, act, cfg, rot_cache=True)
        rows.append(logits[0].numpy())
    assert int(cache.lengths[1]) == len(PROMPT) + len(feed)
    return np.stack(rows)


@pytest.mark.parametrize("kind", ["f32", "f16"])
def test_f32_logits_match_jax(f32_path, kind):
    jl, tl = j_load(f32_path), t_load(f32_path, device="cpu")
    ref, got = run_jax(jl, kind), run_port(tl.weights, tl.cfg, kind)
    assert got.shape == (len(FEED) + 1, tl.cfg.n_vocab)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["q8_0", "q4_0"])
def test_quantized_kv_logits_match_jax(f32_path, kind):
    """Quantized KV in the layout both packages pick (default_layout:
    "dt"), prefill then decode. The two packages' f32 K/V rows differ in
    summation order (~1e-7), and a row value that sits on a rounding
    boundary quantizes one step apart, which moves later logits by ~1e-3;
    so each step starts both packages from the same cache bytes (JAX's),
    holds the logits to the 1e-4 of f16, and holds what the port appended
    to JAX's bytes within one quantization step (almost all identical)."""
    jl, tl = j_load(f32_path), t_load(f32_path, device="cpu")
    c = jl.cfg
    layout = t_layout(kind, c.head_dim)
    assert layout == j_layout(kind, c.head_dim) == "dt"
    jc = j_cache(c.n_layer, 2, 64, c.n_kv_head, c.head_dim, kind=kind,
                 layout=layout)
    tc = t_cache(c.n_layer, 2, 64, c.n_kv_head, c.head_dim, kind=kind,
                 layout=layout, device="cpu")
    one, act = jnp.asarray([1], jnp.int32), jnp.asarray([True])
    tone, tact = torch.tensor([1], dtype=torch.int32), torch.tensor([True])
    planes = ("k", "v", "k_scale", "v_scale", "lengths")
    same = total = 0
    for toks in [PROMPT] + [[t] for t in FEED]:
        for name in planes:  # the port starts from JAX's cache bytes
            getattr(tc, name).copy_(torch.from_numpy(
                np.array(getattr(jc, name))))
        jlog, jc, _ = j_fwd(jl.weights, jc, jnp.asarray([toks], jnp.int32),
                            one, act, c, rot_cache=True)
        tlog, tc, _ = t_fwd(tl.weights, tc, torch.tensor([toks], dtype=torch.int32),
                            tone, tact, tl.cfg, rot_cache=True)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
        for cells, scale in (("k", "k_scale"), ("v", "v_scale")):
            jq, tq = np.asarray(getattr(jc, cells)), getattr(tc, cells).numpy()
            js, ts = np.asarray(getattr(jc, scale)), getattr(tc, scale).numpy()
            np.testing.assert_allclose(ts, js, rtol=1e-5, atol=0)
            jd = np.asarray(j_dequant(jnp.swapaxes(jq, -1, -2), js, kind))
            td = np.asarray(j_dequant(jnp.swapaxes(tq, -1, -2), ts, kind))
            step = np.maximum(js, ts)[..., None] * (1 + 1e-5)
            assert np.all(np.abs(jd - td) <= step)
            same += int((jq == tq).sum())
            total += jq.size
    assert same >= 0.99 * total, (same, total)


def _mapping(qt):
    return dict(qs=np.asarray(qt.qs), kind=qt.kind, group=qt.group,
                scale=None if qt.scale is None else np.asarray(qt.scale),
                bias=None if qt.bias is None else np.asarray(qt.bias),
                shape=qt.shape, perm=qt.perm, perm_shards=qt.perm_shards,
                packed=qt.packed, k_pad=qt.k_pad)


def _as_plain(tree):
    from tpu_engine.model.weights import QTensor as JQ

    if isinstance(tree, JQ):
        return _mapping(tree)
    if isinstance(tree, dict):
        return {k: _as_plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_plain(v) for v in tree]
    return np.asarray(tree)


@pytest.mark.parametrize("which", ["f32", "mix"])
def test_from_jax_params_equals_port_loader(f32_path, mix_path, monkeypatch,
                                            which):
    """The JAX package's weights (stacked for the uniform f32 model, a
    per-layer list for the Q4_K_M mix; f32 scale storage) carried across
    give exactly the port loader's logits."""
    path = f32_path if which == "f32" else mix_path
    monkeypatch.setenv("TPU_ENGINE_BF16_SCALES", "0")
    jl, tl = j_load(path), t_load(path, device="cpu")
    assert isinstance(jl.weights["layers"], dict if which == "f32" else list)
    carried = from_jax_params(_as_plain(jl.weights), jl.cfg, "cpu")
    assert isinstance(carried["layers"], list)
    assert set(carried["layers"][-1]) == set(tl.weights["layers"][-1])
    np.testing.assert_array_equal(run_port(carried, tl.cfg, feed=FEED[:2]),
                                  run_port(tl.weights, tl.cfg, feed=FEED[:2]))


def test_q4km_mix_kl_and_top1(mix_path):
    jl, tl = j_load(mix_path), t_load(mix_path, device="cpu")
    lw = tl.weights["layers"]
    assert "wqkv" in lw[0] and lw[0]["wqkv"].kind == "nib4"
    assert "wqkv" not in lw[3] and lw[3]["wv"].kind == "i8"  # Q6_K v
    assert lw[3]["w_down"].kind == "i8" and tl.weights["output"].kind == "i8"
    ref, got = run_jax(jl), run_port(tl.weights, tl.cfg)

    def logp(x):
        x = x.astype(np.float64)
        x = x - x.max(-1, keepdims=True)
        return x - np.log(np.exp(x).sum(-1, keepdims=True))

    lp, lq = logp(ref), logp(got)
    kl = (np.exp(lp) * (lp - lq)).sum(-1)
    assert kl.max() < 1e-3, kl
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_greedy_decode_loop_tokens_match_jax(f32_path):
    jl, tl = j_load(f32_path), t_load(f32_path, device="cpu")
    c, S, n = jl.cfg, 2, 16
    jc = j_cache(c.n_layer, S, 64, c.n_kv_head, c.head_dim, kind="f32")
    tc = t_cache(c.n_layer, S, 64, c.n_kv_head, c.head_dim, kind="f32",
                 device="cpu")
    prompts = np.asarray([PROMPT, PROMPT[::-1]], np.int32)
    jlog, jc, _ = j_fwd(jl.weights, jc, jnp.asarray(prompts),
                        jnp.arange(S, dtype=jnp.int32), jnp.ones((S,), bool), c,
                        rot_cache=True)
    tlog, tc, _ = t_fwd(tl.weights, tc, torch.from_numpy(prompts),
                        torch.arange(S, dtype=torch.int32),
                        torch.ones((S,), dtype=torch.bool), tl.cfg,
                        rot_cache=True)
    first = np.asarray(jlog).argmax(-1).astype(np.int32)
    np.testing.assert_array_equal(tlog.numpy().argmax(-1), first)
    jp = JS.params_from_host([SamplingParams(temperature=0.0)] * S)
    tp = TS.params_from_host([TSP(temperature=0.0)] * S, device="cpu")
    jtoks, _, _, _ = j_loop(jl.weights, jc, jnp.asarray(first),
                            jnp.ones((S,), bool), c, jp, JS.new_state(S), n,
                            rot_cache=True)
    ttoks, last, tc, _ = t_loop(tl.weights, tc, torch.from_numpy(first),
                                torch.ones((S,), dtype=torch.bool), tl.cfg, tp,
                                TS.new_state(S, device="cpu"), n, rot_cache=True)
    assert ttoks.shape == (S, n)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(last.numpy(), ttoks[:, -1].numpy())
    assert tc.lengths.tolist() == [len(PROMPT) + n] * S


def test_qtensor_layout_is_natural(mix_path):
    """Loaded QTensors carry the natural layout: no group transposition, no
    lane padding, f32 scales."""
    tl = t_load(mix_path, device="cpu")
    qt = tl.weights["layers"][0]["wo"]
    assert isinstance(qt, QTensor) and qt.kind == "nib4"
    n, k = qt.shape
    assert tuple(qt.qs.shape) == (n, k // 2) and qt.qs.dtype == torch.uint8
    assert tuple(qt.scale.shape) == (n, k // 32)
    assert qt.scale.dtype == torch.float32 and qt.bias.dtype == torch.float32
