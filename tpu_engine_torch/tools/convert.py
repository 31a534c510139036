"""HF checkpoint -> GGUF converter (+ GGUF requantizer).

A copy of the JAX package's tools/convert.py (which imports no JAX),
kept in the port so that the port never imports the JAX package. It is
the reference's model pipeline (HF -> GGUF -> quantize over q2_k..q8_0):
it follows the public GGUF conversion conventions (e.g. the Wq/Wk row
permutation that converts HF's half-split RoPE layout to ggml's
interleaved "norm" layout), so files are interchangeable with llama.cpp
tooling. The converters read only `hf_model.config` and
`hf_model.state_dict()`, so any object with those two (a transformers
model, or a config namespace and a dict of tensors) converts.
"""

from __future__ import annotations

import numpy as np

from ..gguf.constants import GGMLType, QUANT_LEVEL_ALIASES
from ..gguf.writer import GGUFWriter
from ..gguf.constants import GGUFValueType


def permute_rope_rows(w: np.ndarray, n_head: int) -> np.ndarray:
    """HF half-split rope layout -> ggml interleaved ("norm") layout."""
    out_dim = w.shape[0]
    return (
        w.reshape(n_head, 2, out_dim // n_head // 2, *w.shape[1:])
        .swapaxes(1, 2)
        .reshape(w.shape)
    )


def _should_quantize(name: str, arr: np.ndarray) -> bool:
    """Norms/biases stay f32; 2D matmul weights quantize (llama.cpp rule)."""
    if arr.ndim < 2:
        return False
    if "norm" in name or "bias" in name:
        return False
    return arr.shape[-1] % 256 == 0


def add_tokenizer_metadata(w: GGUFWriter, tok_md: dict) -> None:
    for key, val in tok_md.items():
        if key == "tokenizer.ggml.tokens":
            w.add_array(key, val, GGUFValueType.STRING)
        elif key == "tokenizer.ggml.scores":
            w.add_array(key, [float(x) for x in val], GGUFValueType.FLOAT32)
        elif key == "tokenizer.ggml.token_type":
            w.add_array(key, [int(x) for x in val], GGUFValueType.INT32)
        elif key == "tokenizer.ggml.merges":
            w.add_array(key, val, GGUFValueType.STRING)
        else:
            w.add(key, val)


def llama3_rope_factors(head_dim: int, base: float, factor: float,
                        low_ff: float, high_ff: float, old_ctx: int) -> np.ndarray:
    """rope_freqs.weight of the llama3 rule (ggml freq_factors): each
    pair's divisor of its inverse frequency."""
    freqs = 1.0 / base ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    wavelen = 2 * np.pi / freqs
    low_wl, high_wl = old_ctx / low_ff, old_ctx / high_ff
    smooth = (old_ctx / wavelen - low_ff) / (high_ff - low_ff)
    return np.where(
        wavelen < high_wl, 1.0,
        np.where(wavelen > low_wl, factor,
                 1.0 / ((1.0 - smooth) / factor + smooth))
    ).astype(np.float32)


def hf_llama_to_gguf(
    hf_model,
    out_path: str,
    ggml_type: GGMLType | str = GGMLType.F32,
    tokenizer_metadata: dict | None = None,
    name: str = "converted",
) -> None:
    """Convert a transformers causal-LM to GGUF, following llama.cpp's
    per-arch file conventions (the weekend-matrix model families, SURVEY.md
    section 4): llama/mistral/tinyllama (rope-permuted), qwen2 (qkv bias),
    gemma (tied embd, +1 norms), gemma2 (+ post norms, softcaps), phi3
    (fused attn_qkv and gate|up ffn_up)."""
    if isinstance(ggml_type, str):
        ggml_type = QUANT_LEVEL_ALIASES[ggml_type.lower()]
    cfg = hf_model.config
    arch = getattr(cfg, "model_type", "llama")
    if arch not in ("llama", "mistral", "qwen2", "gemma", "gemma2", "phi3"):
        raise NotImplementedError(f"hf arch {arch}")
    gguf_arch = {"mistral": "llama"}.get(arch, arch)
    permute = gguf_arch == "llama"

    sd = {k: v.detach().to("cpu").float().numpy() for k, v in hf_model.state_dict().items()}
    n_head = cfg.num_attention_heads
    n_kv = getattr(cfg, "num_key_value_heads", n_head)

    w = GGUFWriter(out_path)
    w.add("general.architecture", gguf_arch)
    w.add("general.name", name)
    w.add(f"{gguf_arch}.block_count", int(cfg.num_hidden_layers))
    w.add(f"{gguf_arch}.context_length", int(getattr(cfg, "max_position_embeddings", 2048)))
    w.add(f"{gguf_arch}.embedding_length", int(cfg.hidden_size))
    w.add(f"{gguf_arch}.feed_forward_length", int(cfg.intermediate_size))
    w.add(f"{gguf_arch}.attention.head_count", int(n_head))
    w.add(f"{gguf_arch}.attention.head_count_kv", int(n_kv))
    w.add(f"{gguf_arch}.attention.layer_norm_rms_epsilon", float(cfg.rms_norm_eps))
    w.add(f"{gguf_arch}.rope.freq_base", float(getattr(cfg, "rope_theta", 10000.0)))
    head_dim = getattr(cfg, "head_dim", None) or cfg.hidden_size // n_head
    w.add(f"{gguf_arch}.rope.dimension_count", int(head_dim))
    w.add(f"{gguf_arch}.attention.key_length", int(head_dim))
    w.add(f"{gguf_arch}.vocab_size", int(cfg.vocab_size))

    # rope scaling, following convert_hf_to_gguf.py conventions: linear and
    # yarn become metadata; llama3 factor curves become the
    # rope_freqs.weight tensor (ggml freq_factors), no scaling metadata
    rs = getattr(cfg, "rope_scaling", None) or {}
    rtype = rs.get("rope_type", rs.get("type"))
    rope_factors = None
    if rtype == "linear":
        w.add(f"{gguf_arch}.rope.scaling.type", "linear")
        w.add(f"{gguf_arch}.rope.scaling.factor", float(rs["factor"]))
    elif rtype == "yarn":
        w.add(f"{gguf_arch}.rope.scaling.type", "yarn")
        w.add(f"{gguf_arch}.rope.scaling.factor", float(rs["factor"]))
        w.add(f"{gguf_arch}.rope.scaling.original_context_length",
              int(rs["original_max_position_embeddings"]))
    elif rtype == "llama3":
        rope_factors = llama3_rope_factors(
            getattr(cfg, "head_dim", None) or cfg.hidden_size // n_head,
            float(getattr(cfg, "rope_theta", 10000.0)),
            float(rs.get("factor", 8.0)), float(rs.get("low_freq_factor", 1.0)),
            float(rs.get("high_freq_factor", 4.0)),
            int(rs.get("original_max_position_embeddings", 8192)))

    if tokenizer_metadata:
        add_tokenizer_metadata(w, tokenizer_metadata)

    def put(gname: str, arr: np.ndarray, force_f32: bool = False):
        ty = ggml_type if (not force_f32 and _should_quantize(gname, arr)) else GGMLType.F32
        w.add_tensor(gname, arr, ty)

    if arch == "gemma2":
        w.add("gemma2.attn_logit_softcapping",
              float(getattr(cfg, "attn_logit_softcapping", 50.0)))
        w.add("gemma2.final_logit_softcapping",
              float(getattr(cfg, "final_logit_softcapping", 30.0)))
        w.add("gemma2.attention.sliding_window",
              int(getattr(cfg, "sliding_window", 4096)))
        # not in llama.cpp's gemma2 GGUF spec (it keys the 27B scale off
        # model size); we persist it so attention scaling is exact for any
        # query_pre_attn_scalar (config.py falls back to the 4608 rule)
        qpas = getattr(cfg, "query_pre_attn_scalar", None)
        if qpas:
            w.add("gemma2.attention.query_pre_attn_scalar", float(qpas))

    put("token_embd.weight", sd["model.embed_tokens.weight"])
    put("output_norm.weight", sd["model.norm.weight"])
    if rope_factors is not None:
        w.add_tensor("rope_freqs.weight", rope_factors, GGMLType.F32)
    tied = getattr(cfg, "tie_word_embeddings", False) or arch.startswith("gemma")
    if "lm_head.weight" in sd and not tied:
        put("output.weight", sd["lm_head.weight"])

    for i in range(cfg.num_hidden_layers):
        hp = f"model.layers.{i}."
        gp = f"blk.{i}."
        put(gp + "attn_norm.weight", sd[hp + "input_layernorm.weight"])
        if arch == "phi3":
            # llama.cpp phi3 convention: fused qkv and gate|up tensors
            put(gp + "attn_qkv.weight", sd[hp + "self_attn.qkv_proj.weight"])
            put(gp + "attn_output.weight", sd[hp + "self_attn.o_proj.weight"])
            put(gp + "ffn_norm.weight", sd[hp + "post_attention_layernorm.weight"])
            put(gp + "ffn_up.weight", sd[hp + "mlp.gate_up_proj.weight"])
            put(gp + "ffn_down.weight", sd[hp + "mlp.down_proj.weight"])
            continue
        wq = sd[hp + "self_attn.q_proj.weight"]
        wk = sd[hp + "self_attn.k_proj.weight"]
        if permute:
            wq = permute_rope_rows(wq, n_head)
            wk = permute_rope_rows(wk, n_kv)
        put(gp + "attn_q.weight", wq)
        put(gp + "attn_k.weight", wk)
        put(gp + "attn_v.weight", sd[hp + "self_attn.v_proj.weight"])
        put(gp + "attn_output.weight", sd[hp + "self_attn.o_proj.weight"])
        if hp + "self_attn.q_proj.bias" in sd:
            put(gp + "attn_q.bias", sd[hp + "self_attn.q_proj.bias"], force_f32=True)
            put(gp + "attn_k.bias", sd[hp + "self_attn.k_proj.bias"], force_f32=True)
            put(gp + "attn_v.bias", sd[hp + "self_attn.v_proj.bias"], force_f32=True)
        if arch == "gemma2":
            # gemma2's four norms: input -> attn_norm, post_attention ->
            # post_attention_norm, pre_feedforward -> ffn_norm,
            # post_feedforward -> post_ffw_norm (llama.cpp naming)
            put(gp + "post_attention_norm.weight",
                sd[hp + "post_attention_layernorm.weight"])
            put(gp + "ffn_norm.weight",
                sd[hp + "pre_feedforward_layernorm.weight"])
            put(gp + "post_ffw_norm.weight",
                sd[hp + "post_feedforward_layernorm.weight"])
        else:
            put(gp + "ffn_norm.weight", sd[hp + "post_attention_layernorm.weight"])
        put(gp + "ffn_gate.weight", sd[hp + "mlp.gate_proj.weight"])
        put(gp + "ffn_up.weight", sd[hp + "mlp.up_proj.weight"])
        put(gp + "ffn_down.weight", sd[hp + "mlp.down_proj.weight"])

    w.write()


def hf_bert_to_gguf(
    hf_model,
    out_path: str,
    ggml_type: GGMLType | str = GGMLType.F32,
    tokenizer_metadata: dict | None = None,
    pooling_type: int = 1,  # llama.cpp enum: 1 mean, 2 cls, 3 last
    name: str = "bert",
) -> None:
    """Convert a transformers BertModel to a bert-arch GGUF (llama.cpp's
    encoder tensor conventions — the reference's embedding-model family,
    nomic-embed in the reference's Makefile)."""
    if isinstance(ggml_type, str):
        ggml_type = QUANT_LEVEL_ALIASES[ggml_type.lower()]
    cfg = hf_model.config
    sd = {k: v.detach().to("cpu").float().numpy()
          for k, v in hf_model.state_dict().items()}
    # accept both BertModel ("embeddings...") and wrappers ("bert.embeddings")
    if any(k.startswith("bert.") for k in sd):
        sd = {k[5:]: v for k, v in sd.items() if k.startswith("bert.")}

    w = GGUFWriter(out_path)
    w.add("general.architecture", "bert")
    w.add("general.name", name)
    w.add("bert.block_count", int(cfg.num_hidden_layers))
    w.add("bert.context_length", int(cfg.max_position_embeddings))
    w.add("bert.embedding_length", int(cfg.hidden_size))
    w.add("bert.feed_forward_length", int(cfg.intermediate_size))
    w.add("bert.attention.head_count", int(cfg.num_attention_heads))
    w.add("bert.attention.layer_norm_epsilon", float(cfg.layer_norm_eps))
    w.add("bert.pooling_type", int(pooling_type))
    w.add("bert.vocab_size", int(cfg.vocab_size))
    w.add("bert.attention.causal", False)
    if tokenizer_metadata:
        add_tokenizer_metadata(w, tokenizer_metadata)

    def put(gname, arr, force_f32=False):
        ty = ggml_type if (not force_f32 and _should_quantize(gname, arr)) else GGMLType.F32
        w.add_tensor(gname, arr, ty)

    put("token_embd.weight", sd["embeddings.word_embeddings.weight"])
    put("token_types.weight", sd["embeddings.token_type_embeddings.weight"],
        force_f32=True)
    put("position_embd.weight", sd["embeddings.position_embeddings.weight"],
        force_f32=True)
    put("token_embd_norm.weight", sd["embeddings.LayerNorm.weight"])
    put("token_embd_norm.bias", sd["embeddings.LayerNorm.bias"])
    for i in range(cfg.num_hidden_layers):
        hp = f"encoder.layer.{i}."
        gp = f"blk.{i}."
        for hname, gname in (
            ("attention.self.query", "attn_q"),
            ("attention.self.key", "attn_k"),
            ("attention.self.value", "attn_v"),
            ("attention.output.dense", "attn_output"),
            ("intermediate.dense", "ffn_up"),
            ("output.dense", "ffn_down"),
        ):
            put(gp + gname + ".weight", sd[hp + hname + ".weight"])
            put(gp + gname + ".bias", sd[hp + hname + ".bias"], force_f32=True)
        put(gp + "attn_output_norm.weight", sd[hp + "attention.output.LayerNorm.weight"])
        put(gp + "attn_output_norm.bias", sd[hp + "attention.output.LayerNorm.bias"])
        put(gp + "layer_output_norm.weight", sd[hp + "output.LayerNorm.weight"])
        put(gp + "layer_output_norm.bias", sd[hp + "output.LayerNorm.bias"])
    w.write()


def requantize_gguf(in_path: str, out_path: str, level: str) -> None:
    """GGUF -> GGUF at a different quant level (llama-quantize analog)."""
    from ..gguf.reader import read_gguf

    ty = QUANT_LEVEL_ALIASES[level.lower()]
    with read_gguf(in_path) as g:
        w = GGUFWriter(out_path)
        for key, val in g.metadata.items():
            if isinstance(val, np.ndarray):
                np_to_vt = {
                    np.dtype(np.float32): GGUFValueType.FLOAT32,
                    np.dtype(np.int32): GGUFValueType.INT32,
                    np.dtype(np.uint32): GGUFValueType.UINT32,
                    np.dtype(np.int64): GGUFValueType.INT64,
                }
                w.add_array(key, val.tolist(), np_to_vt[val.dtype])
            elif isinstance(val, list):
                w.add_array(
                    key, val,
                    GGUFValueType.STRING if val and isinstance(val[0], str) else GGUFValueType.INT32,
                )
            else:
                w.add(key, val)
        for tname, ti in g.tensors.items():
            arr = g.dequantize(tname, np.float32)
            if _should_quantize(tname, arr):
                w.add_tensor(tname, arr, ty)
            else:
                w.add_tensor(tname, arr, GGMLType.F32)
        w.write()
