"""The port's family paths against the JAX package, over the families of
tests/test_archs.py: gemma (tied embeddings, +1 norms, GeGLU), gemma2
(post norms, attention and final softcaps, query_pre_attn_scalar, the
alternating sliding window), phi3 (fused attn_qkv and gate|up on disk),
qwen2 (q/k/v biases) and llama with llama3 (rope_freqs), yarn and linear
rope scaling. Each tiny HF model is converted by the JAX package's
hf_llama_to_gguf at f32 and loaded by both packages; prefill logits
and those of stepwise decode agree within rtol = atol = 1e-4, as in
tests/test_torch_model.py, at an f32 and an f16 KV cache. Both sides are
f32 and differ only in sum order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.models import tokenizer_metadata
from tests.test_archs import (PROMPT, VOCAB, tiny_gemma, tiny_gemma2,
                              tiny_llama_scaled, tiny_phi3, tiny_qwen2)
from tpu_engine.kvcache.cache import new_cache as j_cache
from tpu_engine.model.llama import forward_step as j_fwd
from tpu_engine.model.loader import load_model as j_load
from tpu_engine.tools.convert import hf_llama_to_gguf
from tpu_engine_torch.kvcache.cache import new_cache as t_cache
from tpu_engine_torch.model.llama import forward_step as t_fwd
from tpu_engine_torch.model.loader import load_model as t_load

torch.set_num_threads(2)

FEED = [33, 77, 120, 5, 301]


def gemma2_window6(seed=21):
    """tests/test_archs.py::test_gemma2_sliding_window_matches_hf's model:
    a 6-token window on alternate layers."""
    from transformers import Gemma2Config, Gemma2ForCausalLM

    torch.manual_seed(seed)
    return Gemma2ForCausalLM(Gemma2Config(
        vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=32,
        intermediate_size=128, max_position_embeddings=2048,
        rms_norm_eps=1e-6, rope_theta=10000.0,
        attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        query_pre_attn_scalar=32, sliding_window=6,
        attn_implementation="eager")).eval()


SCALED = {
    "llama3": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0, "original_max_position_embeddings": 32},
    "yarn": {"rope_type": "yarn", "factor": 4.0,
             "original_max_position_embeddings": 32},
    "linear": {"rope_type": "linear", "factor": 4.0},
}
MODELS = {
    "gemma": tiny_gemma, "gemma2": tiny_gemma2, "phi3": tiny_phi3,
    "qwen2": tiny_qwen2, "gemma2-window6": gemma2_window6,
    **{name: (lambda rs=rs: tiny_llama_scaled(rs)) for name, rs in SCALED.items()},
}
# rope-scaled models run a 56-token prompt, past their original context
# (32), as test_rope_scaling_matches_hf does; gemma2-window6 a 12-token one
LONG = [1] + np.random.RandomState(3).randint(4, VOCAB, size=55).tolist()


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("archs")
    out = {}
    for name, build in MODELS.items():
        p = str(d / f"{name}.gguf")
        hf_llama_to_gguf(build(), p, "f32", tokenizer_metadata(VOCAB), name=name)
        out[name] = p
    return out


def _prompt(name):
    if name in SCALED:
        return LONG
    return PROMPT + [33, 44, 55, 66] if name == "gemma2-window6" else PROMPT


def run_jax(lm, prompt, kind, window=None):
    c = lm.cfg
    if window is not None:
        c.sliding_window, c.swa_alternate = window, True
    cache = j_cache(c.n_layer, 1, 128, c.n_kv_head, c.head_dim, kind=kind)
    one, act = jnp.asarray([0], jnp.int32), jnp.asarray([True])
    logits, cache, _ = j_fwd(lm.weights, cache, jnp.asarray([prompt], jnp.int32),
                             one, act, c, rot_cache=True)
    rows = [np.asarray(logits)[0]]
    for t in FEED:
        logits, cache, _ = j_fwd(lm.weights, cache, jnp.asarray([[t]], jnp.int32),
                                 one, act, c, rot_cache=True)
        rows.append(np.asarray(logits)[0])
    return np.stack(rows)


def run_port(lm, prompt, kind, window=None):
    c = lm.cfg
    if window is not None:
        c.sliding_window, c.swa_alternate = window, True
    cache = t_cache(c.n_layer, 1, 128, c.n_kv_head, c.head_dim, kind=kind,
                    device="cpu")
    one, act = torch.tensor([0], dtype=torch.int32), torch.tensor([True])
    logits, cache, _ = t_fwd(lm.weights, cache, torch.tensor([prompt], dtype=torch.int32),
                             one, act, c, rot_cache=True)
    rows = [logits[0].numpy()]
    for t in FEED:
        logits, cache, _ = t_fwd(lm.weights, cache, torch.tensor([[t]], dtype=torch.int32),
                                 one, act, c, rot_cache=True)
        rows.append(logits[0].numpy())
    assert int(cache.lengths[0]) == len(prompt) + len(FEED)
    return np.stack(rows)


@pytest.mark.parametrize("kind", ["f32", "f16"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_family_logits_match_jax(paths, name, kind):
    """Prefill then five decode steps: the port's logits against the JAX
    package's at 1e-4, with each family's config read the same way."""
    jl, tl = j_load(paths[name]), t_load(paths[name], device="cpu")
    assert tl.cfg.arch == jl.cfg.arch
    for field in ("attn_logit_softcap", "final_logit_softcap", "post_norms",
                  "sliding_window", "swa_alternate", "rope_scaling",
                  "rope_scaling_type", "rope_freqs", "embedding_scale",
                  "tie_embeddings", "act", "qkv_bias"):
        assert getattr(tl.cfg, field) == getattr(jl.cfg, field), field
    np.testing.assert_allclose(np.asarray(tl.cfg.attention_scale()),
                               np.asarray(jl.cfg.attention_scale()), rtol=1e-7)
    prompt = _prompt(name)
    ref, got = run_jax(jl, prompt, kind), run_port(tl, prompt, kind)
    assert got.shape == (len(FEED) + 1, VOCAB)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["f32", "f16"])
def test_gemma2_window_past_its_length(paths, kind):
    """gemma2's alternating local/global mask with the window (5) shorter
    than the prompt (8) and every decode step (test_archs.py's
    test_gemma2_sliding_window_decode): the port equals the JAX package,
    and the window changes the logits."""
    jl, tl = j_load(paths["gemma2"]), t_load(paths["gemma2"], device="cpu")
    ref = run_jax(jl, PROMPT, kind, window=5)
    got = run_port(tl, PROMPT, kind, window=5)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    tl_full = t_load(paths["gemma2"], device="cpu")
    full = run_port(tl_full, PROMPT, kind)
    assert np.abs(full - got).max() > 1e-3


def test_phi3_fused_tensors(paths):
    """phi3's fused attn_qkv and gate|up (ffn_up, 2 * n_ff rows) load as the
    port's fused weights, with the JAX package's shapes."""
    jl, tl = j_load(paths["phi3"]), t_load(paths["phi3"], device="cpu")
    for lw in tl.weights["layers"]:
        assert {"wqkv", "w_gateup"} <= set(lw)
        assert not {"wq", "wk", "wv", "w_gate", "w_up"} & set(lw)
        assert lw["wqkv"].shape == tuple(jl.weights["layers"]["wqkv"].shape)
        assert lw["w_gateup"].shape == tuple(jl.weights["layers"]["w_gateup"].shape)
        assert lw["w_gateup"].shape[0] == 2 * tl.cfg.n_ff


def test_qwen2_biases(paths):
    """qwen2's q/k/v biases load fused beside the fused q|k|v weight."""
    tl = t_load(paths["qwen2"], device="cpu")
    lw = tl.weights["layers"][0]
    assert "bqkv" in lw and lw["bqkv"].shape[0] == lw["wqkv"].shape[0]
    assert tl.cfg.qkv_bias
