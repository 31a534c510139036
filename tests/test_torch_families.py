"""tools/family_gguf.py's four families (gemma2, qwen2, phi3, llama3.1)
through the port against the JAX package, at tiny widths: the writer's
`widths=` override at depth 2, with the published files' type rule and
metadata.

  - every tensor's GGML type is llama.cpp's Q4_K_M type for that
    architecture (the table below, written out independently);
  - the layout (metadata and tensor names and shapes) is the one the JAX
    package's tools/convert.hf_llama_to_gguf writes for the architecture,
    with llama.cpp's phi3 sliding window key on top;
  - both loaders read the same config from each file, and the published
    widths from each family's metadata;
  - prefill and stepwise decode logits of the JAX package (JAX-CPU, f32
    scales: TPU_ENGINE_BF16_SCALES=0 as in tests/test_torch_bert.py) and
    of the port's plain path agree within rtol = atol = 1e-4, at an f32
    and an f16 KV cache, and with a window shorter than the prompt
    (gemma2 on alternate layers, phi3 on every layer); each step starts
    the port from the JAX package's cache bytes;
  - build_q4km_gguf, the Llama-2 smoke model's writer, still writes the
    bytes it wrote before the family writer existed (SHA-256 of its
    "tiny" and "mini" files at seed 0).
"""

import hashlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.kvcache.cache import new_cache as j_cache
from tpu_engine.model.config import ModelConfig as JConfig
from tpu_engine.model.llama import forward_step as j_fwd
from tpu_engine.model.loader import load_model as j_load
from tpu_engine.tools.convert import hf_llama_to_gguf
from tpu_engine_torch.gguf.constants import GGMLType
from tpu_engine_torch.gguf.reader import read_gguf
from tpu_engine_torch.kvcache.cache import new_cache as t_cache
from tpu_engine_torch.model.config import ModelConfig as TConfig
from tpu_engine_torch.model.llama import forward_step as t_fwd
from tpu_engine_torch.model.loader import load_model as t_load
from tpu_engine_torch.tools.family_gguf import (FAMILIES, Widths,
                                                build_family_gguf,
                                                family_metadata)
from tpu_engine_torch.tools.q4km import build_q4km_gguf

torch.set_num_threads(2)

# every K a multiple of 256 (so each 2-D weight takes its k-quant), the
# families' head shapes where that allows: gemma2 D=256 G=2, qwen2 G=7,
# phi3 D=96 with E = H * D, llama3.1 G=4
TINY = {
    "gemma2": Widths(2, 256, 2, 1, 256, 512, 512),
    "qwen2": Widths(2, 256, 14, 2, 128, 512, 512),
    "phi3": Widths(2, 768, 8, 8, 96, 512, 512),
    "llama3.1": Widths(2, 256, 4, 1, 64, 512, 512),
}
NAMES = sorted(TINY)
# the published config.json widths: (n_layer, E, H, KH, D, F, V)
PUBLISHED = {
    "gemma2": (42, 3584, 16, 8, 256, 14336, 256000),
    "qwen2": (28, 3584, 28, 4, 128, 18944, 152064),
    "phi3": (32, 3072, 32, 32, 96, 8192, 32064),
    "llama3.1": (32, 4096, 32, 8, 128, 14336, 128256),
}
PROMPT = [1, 270, 272, 274, 280, 300, 310, 320, 9, 77, 123, 45]
FEED = [33, 77, 120, 5, 301]
CFG_FIELDS = ("arch", "n_layer", "n_embd", "n_head", "n_kv_head", "head_dim",
              "n_ff", "n_vocab", "n_ctx_train", "rms_eps", "rope_theta",
              "rope_dim", "rope_type", "act", "qkv_bias", "tie_embeddings",
              "embedding_scale", "attn_logit_softcap", "final_logit_softcap",
              "post_norms", "sliding_window", "swa_alternate", "rope_scaling",
              "rope_scaling_type", "rope_freqs")


def more_bits(i, n):
    """llama.cpp's use_more_bits(i_layer, n_layer)."""
    return i < n // 8 or i >= 7 * n // 8 or (i - n // 8) % 3 == 2


def q4_k_m_type(arch, name, n_layer):
    """llama.cpp's llama_tensor_get_type at LLAMA_FTYPE_MOSTLY_Q4_K_M, for
    the tensors these files hold: 1-D tensors stay F32; the head is Q6_K,
    and so is token_embd when there is no head (tied); attn_v and
    ffn_down take Q6_K on the use_more_bits layers; a fused attn_qkv
    takes Q5_K; every other weight is Q4_K."""
    if name.endswith((".bias", "norm.weight")) or name == "rope_freqs.weight":
        return GGMLType.F32
    if name == "output.weight" or (name == "token_embd.weight"
                                   and arch == "gemma2"):
        return GGMLType.Q6_K
    if name.endswith(".attn_qkv.weight"):
        return GGMLType.Q5_K
    if name.endswith((".attn_v.weight", ".ffn_down.weight")):
        return (GGMLType.Q6_K if more_bits(int(name.split(".")[1]), n_layer)
                else GGMLType.Q4_K)
    return GGMLType.Q4_K


@pytest.fixture(autouse=True)
def f32_scales(monkeypatch):
    monkeypatch.setenv("TPU_ENGINE_BF16_SCALES", "0")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("families")
    return {name: build_family_gguf(str(d / f"{name}.gguf"), name, n_layer=2,
                                    seed=0, widths=TINY[name], threads=2)
            for name in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_family_tensor_types(paths, name):
    """Each tensor's type is the Q4_K_M rule's for its architecture, and
    each family carries the tensors that set it apart."""
    arch = FAMILIES[name].arch
    with read_gguf(paths[name]) as g:
        types = {n: t.ggml_type for n, t in g.tensors.items()}
    assert types == {n: q4_k_m_type(arch, n, 2) for n in types}
    assert types["blk.1.ffn_down.weight"] == GGMLType.Q6_K  # use_more_bits
    assert types["blk.0.ffn_down.weight"] == GGMLType.Q4_K
    own = {"gemma2": {"blk.0.post_attention_norm.weight",
                      "blk.1.post_ffw_norm.weight"},
           "qwen2": {"blk.0.attn_q.bias", "blk.1.attn_v.bias"},
           "phi3": {"blk.0.attn_qkv.weight", "blk.1.attn_qkv.weight"},
           "llama3.1": {"rope_freqs.weight", "output.weight"}}[name]
    assert own <= set(types)
    assert ("output.weight" in types) == (arch != "gemma2")


def _hf_stand_in(name, w):
    """A config namespace and a zero state dict under HF's names, as
    hf_llama_to_gguf reads a transformers model, for `name` at widths w."""
    fam = FAMILIES[name]
    E, D, F, V = w.n_embd, w.head_dim, w.n_ff, w.n_vocab
    q, kv = w.n_head * D, w.n_kv_head * D
    extra = dict(fam.extra)
    rope = fam.llama3_rope
    cfg = SimpleNamespace(
        model_type=fam.arch, num_hidden_layers=w.n_layer,
        max_position_embeddings=fam.n_ctx_train, hidden_size=E,
        intermediate_size=F, num_attention_heads=w.n_head,
        num_key_value_heads=w.n_kv_head, rms_norm_eps=fam.rms_eps,
        rope_theta=fam.rope_theta, head_dim=D, vocab_size=V,
        tie_word_embeddings=fam.arch == "gemma2",
        rope_scaling=dict(rope_type="llama3", factor=rope[0],
                          low_freq_factor=rope[1], high_freq_factor=rope[2],
                          original_max_position_embeddings=rope[3])
        if rope else None,
        attn_logit_softcapping=extra.get("attn_logit_softcapping"),
        final_logit_softcapping=extra.get("final_logit_softcapping"),
        sliding_window=extra.get("attention.sliding_window"),
        query_pre_attn_scalar=extra.get("attention.query_pre_attn_scalar"))
    z = torch.zeros
    sd = {"model.embed_tokens.weight": z(V, E), "model.norm.weight": z(E)}
    if fam.arch != "gemma2":
        sd["lm_head.weight"] = z(V, E)
    for i in range(w.n_layer):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = z(E)
        sd[p + "post_attention_layernorm.weight"] = z(E)
        sd[p + "self_attn.o_proj.weight"] = z(E, q)
        sd[p + "mlp.down_proj.weight"] = z(E, F)
        if fam.arch == "phi3":
            sd[p + "self_attn.qkv_proj.weight"] = z(q + 2 * kv, E)
            sd[p + "mlp.gate_up_proj.weight"] = z(2 * F, E)
            continue
        sd[p + "self_attn.q_proj.weight"] = z(q, E)
        sd[p + "self_attn.k_proj.weight"] = z(kv, E)
        sd[p + "self_attn.v_proj.weight"] = z(kv, E)
        sd[p + "mlp.gate_proj.weight"] = z(F, E)
        sd[p + "mlp.up_proj.weight"] = z(F, E)
        if fam.arch == "qwen2":
            for n, k in (("q", q), ("k", kv), ("v", kv)):
                sd[p + f"self_attn.{n}_proj.bias"] = z(k)
        if fam.arch == "gemma2":
            sd[p + "pre_feedforward_layernorm.weight"] = z(E)
            sd[p + "post_feedforward_layernorm.weight"] = z(E)
    return SimpleNamespace(config=cfg, state_dict=lambda: sd)


@pytest.mark.parametrize("name", NAMES)
def test_family_layout_matches_converter(paths, tmp_path, name):
    """The file's metadata and tensor names and shapes are those the JAX
    package's hf_llama_to_gguf writes for the architecture (phi3 adds
    llama.cpp's attention.sliding_window, which that converter leaves
    out), and llama3.1's rope_freqs equal the converter's."""
    ref = str(tmp_path / "ref.gguf")
    tok = {k: v for k, v in family_metadata(name, 2, TINY[name]).items()
           if k.startswith("tokenizer.")}
    hf_llama_to_gguf(_hf_stand_in(name, TINY[name]), ref, "f32", tok)
    with read_gguf(paths[name]) as g, read_gguf(ref) as r:
        md, want = ({k: v.tolist() if isinstance(v, np.ndarray) else v
                     for k, v in f.metadata.items() if k != "general.name"}
                    for f in (g, r))
        if name == "phi3":
            assert md.pop("phi3.attention.sliding_window") == 2047
        assert md == want
        assert ({n: t.shape for n, t in g.tensors.items()}
                == {n: t.shape for n, t in r.tensors.items()})
        if name == "llama3.1":
            np.testing.assert_array_equal(g.dequantize("rope_freqs.weight"),
                                          r.dequantize("rope_freqs.weight"))


@pytest.mark.parametrize("name", NAMES)
def test_family_published_widths(name):
    """Each family's metadata at its published widths gives both packages
    the config.json widths and the same config."""
    md = family_metadata(name, 2)
    jc, tc = JConfig.from_gguf_metadata(md), TConfig.from_gguf_metadata(md)
    L, E, H, KH, D, F, V = PUBLISHED[name]
    assert FAMILIES[name].widths == Widths(L, E, H, KH, D, F, V)
    assert (tc.n_layer, tc.n_embd, tc.n_head, tc.n_kv_head, tc.head_dim,
            tc.n_ff, tc.n_vocab) == (2, E, H, KH, D, F, V)
    for field in CFG_FIELDS:
        assert getattr(tc, field) == getattr(jc, field), field
    assert tc.attention_scale() == jc.attention_scale()
    assert tc.sliding_window == {"gemma2": 4096, "phi3": 2047}.get(name, 0)
    if name == "gemma2":
        assert tc.swa_alternate and tc.attention_scale() == 256 ** -0.5
        assert (tc.attn_logit_softcap, tc.final_logit_softcap) == (50.0, 30.0)


@pytest.mark.parametrize("name", NAMES)
def test_family_config_matches_jax(paths, name):
    """Both loaders read the same config from the file, rope_freqs (from
    the tensor) and the tied head included."""
    jl, tl = j_load(paths[name]), t_load(paths[name], device="cpu")
    for field in CFG_FIELDS:
        assert getattr(tl.cfg, field) == getattr(jl.cfg, field), field
    assert tl.cfg.attention_scale() == pytest.approx(jl.cfg.attention_scale(),
                                                     rel=1e-7)
    assert tl.cfg.tie_embeddings == (name == "gemma2")
    assert bool(tl.cfg.rope_freqs) == (name == "llama3.1")
    assert tl.cfg.qkv_bias == (name == "qwen2")


def _set_cache(tc, jc):
    """The port's cache takes the JAX package's cache bytes."""
    for name in ("k", "v", "lengths"):
        a, dst = np.array(getattr(jc, name)), getattr(tc, name)
        if dst.dtype == torch.bfloat16:
            dst.copy_(torch.from_numpy(a.view(np.int16)).view(torch.bfloat16))
        else:
            dst.copy_(torch.from_numpy(a))


def run_both(jl, tl, kind, window=None):
    """The prompt, then FEED a token a step, through both packages; each
    step starts the port from the JAX package's cache bytes, as
    tests/test_torch_model.py does for quantized KV: at f16 a cell whose
    f32 value the two sum orders round to different bf16 neighbours
    would otherwise carry that one-ulp difference into every later step.
    Returns (JAX logits, port logits) [1 + len(FEED), V]."""
    jc_, tc_ = jl.cfg, tl.cfg
    if window is not None:
        jc_.sliding_window = tc_.sliding_window = window
    jc = j_cache(jc_.n_layer, 1, 64, jc_.n_kv_head, jc_.head_dim, kind=kind)
    tc = t_cache(tc_.n_layer, 1, 64, tc_.n_kv_head, tc_.head_dim, kind=kind,
                 device="cpu")
    one, act = jnp.asarray([0], jnp.int32), jnp.asarray([True])
    tone, tact = torch.tensor([0], dtype=torch.int32), torch.tensor([True])
    ref, got = [], []
    for toks in [PROMPT] + [[t] for t in FEED]:
        _set_cache(tc, jc)
        jlog, jc, _ = j_fwd(jl.weights, jc, jnp.asarray([toks], jnp.int32),
                            one, act, jc_, rot_cache=True)
        tlog, tc, _ = t_fwd(tl.weights, tc, torch.tensor([toks], dtype=torch.int32),
                            tone, tact, tc_, rot_cache=True)
        ref.append(np.asarray(jlog)[0])
        got.append(tlog[0].numpy())
        np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    assert int(tc.lengths[0]) == len(PROMPT) + len(FEED)
    return np.stack(ref), np.stack(got)


@pytest.mark.parametrize("kind", ["f32", "f16"])
@pytest.mark.parametrize("name", NAMES)
def test_family_logits_match_jax(paths, name, kind):
    """Prefill, then five decode steps: the port's plain path against the
    JAX package at 1e-4 (both f32 with f32 scales; sum order only)."""
    ref, got = run_both(j_load(paths[name]), t_load(paths[name], device="cpu"),
                        kind)
    assert got.shape == (len(FEED) + 1, TINY[name].n_vocab)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["gemma2", "phi3"])
def test_family_window_matches_jax(paths, name):
    """A 5-token window, shorter than the prompt and every decode step
    (gemma2: on alternate layers; phi3: on every layer): the port equals
    the JAX package, and the window changes the logits."""
    jl, tl = j_load(paths[name]), t_load(paths[name], device="cpu")
    ref, got = run_both(jl, tl, "f16", window=5)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    _, full = run_both(jl, tl, "f16", window=0)
    assert np.abs(full - got).max() > 1e-3 * np.abs(full).max()


# build_q4km_gguf(path, preset, seed=0) before tools/family_gguf.py existed
Q4KM_SHA256 = {
    "tiny": "76daa440eb6249dfcf12fe5d0e69c3ff83461a546fd418b41059bf6e5d271c37",
    "mini": "1dfa7b48ee993c41de3fdcd85a77c29716a5c3b5e15987c844dd84149e45c7fc",
}


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("preset", sorted(Q4KM_SHA256))
def test_q4km_smoke_writer_pinned(tmp_path, preset):
    """The Llama-2 smoke model's writer draws and writes what it did."""
    path = build_q4km_gguf(str(tmp_path / f"{preset}.gguf"), preset, seed=0)
    assert _sha256(path) == Q4KM_SHA256[preset]


def test_family_file_depends_on_family_and_seed(paths, tmp_path):
    """A file is a function of (family, seed, widths, depth): written again
    it is the same bytes, whatever the thread count; another seed draws
    other weights."""
    again = build_family_gguf(str(tmp_path / "a.gguf"), "qwen2", n_layer=2,
                              seed=0, widths=TINY["qwen2"], threads=1)
    assert _sha256(again) == _sha256(paths["qwen2"])
    other = build_family_gguf(str(tmp_path / "b.gguf"), "qwen2", n_layer=2,
                              seed=1, widths=TINY["qwen2"], threads=2)
    assert _sha256(other) != _sha256(paths["qwen2"])
