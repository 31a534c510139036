"""Random-weight embedding-model GGUFs at published widths.

Two encoder families, as llama.cpp lays them out and model/bert.py reads
them:

  - "bert" (bge-base-en-v1.5's config.json: L=12, E=768, H=12, F=3072,
    V=30522, 512 learned positions, 2 token types, LayerNorm eps 1e-12,
    CLS pooling), written by tools/convert.hf_bert_to_gguf from a random
    state dict, so no transformers is needed;
  - "nomic-bert" (nomic-embed-text-v1.5: L=12, E=768, H=12, F=3072,
    V=30528, 2048 positions by rope with base 1000, SwiGLU, no projection
    biases, mean pooling), written tensor by tensor with separate
    attn_q/k/v. Under "q4_k_m" every 2-D weight is Q4_K except attn_v and
    ffn_down on llama.cpp's use_more_bits layers, which are Q6_K.

Both carry a made-up WordPiece vocabulary of V entries.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from types import SimpleNamespace

import numpy as np
import torch

from ..gguf.constants import QUANT_LEVEL_ALIASES, GGMLType
from ..gguf.writer import GGUFWriter
from ..quant import formats
from .convert import _should_quantize, add_tokenizer_metadata, hf_bert_to_gguf
from .q4km import q4km_type

# (n_layer, n_embd, n_head, n_ff, n_vocab, n_ctx_train)
PRESETS = {
    "bge-base": (12, 768, 12, 3072, 30522, 512),
    "nomic-embed-v1.5": (12, 768, 12, 3072, 30528, 2048),
}
WORDS = ["the", "quick", "brown", "fox", "jump", "##s", "##ed", "##ing",
         "over", "lazy", "dog", "un", "##break", "##able", "hello", "world",
         "!", ",", ".", "search", "query", "document", "embed", "##ding"]


def wordpiece_metadata(n_vocab: int) -> dict:
    """GGUF tokenizer metadata of a WordPiece vocabulary of n_vocab
    entries: the five specials, a few words and pieces, then filler."""
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    toks = specials + WORDS
    toks += [f"tok{i}" for i in range(n_vocab - len(toks))]
    return {
        "tokenizer.ggml.model": "bert",
        "tokenizer.ggml.tokens": toks,
        "tokenizer.ggml.token_type": [3] * len(specials)
        + [1] * (n_vocab - len(specials)),
        "tokenizer.ggml.unknown_token_id": 1,
        "tokenizer.ggml.cls_token_id": 2,
        "tokenizer.ggml.seperator_token_id": 3,
        "tokenizer.ggml.padding_token_id": 0,
    }


def _norm_pair(rng, n):
    w = 1.0 + 0.1 * rng.standard_normal(n, dtype=np.float32)
    return w, 0.02 * rng.standard_normal(n, dtype=np.float32)


def build_bert_gguf(path: str, preset: str = "bge-base", level: str = "q8_0",
                    seed: int = 0, pooling_type: int = 2) -> str:
    """A random bert at the preset's widths, written by hf_bert_to_gguf at
    `level` from a state dict made with numpy from `seed`. pooling_type:
    llama.cpp's enum (1 mean, 2 cls, 3 last)."""
    L, E, H, F, V, ctx = PRESETS[preset]
    rng = np.random.default_rng(seed)

    def mat(*shape):
        return torch.from_numpy(0.02 * rng.standard_normal(shape, dtype=np.float32))

    sd = {"embeddings.word_embeddings.weight": mat(V, E),
          "embeddings.token_type_embeddings.weight": mat(2, E),
          "embeddings.position_embeddings.weight": mat(ctx, E)}
    w, b = _norm_pair(rng, E)
    sd["embeddings.LayerNorm.weight"] = torch.from_numpy(w)
    sd["embeddings.LayerNorm.bias"] = torch.from_numpy(b)
    for i in range(L):
        p = f"encoder.layer.{i}."
        for name, n, k in (("attention.self.query", E, E),
                           ("attention.self.key", E, E),
                           ("attention.self.value", E, E),
                           ("attention.output.dense", E, E),
                           ("intermediate.dense", F, E),
                           ("output.dense", E, F)):
            sd[p + name + ".weight"] = mat(n, k)
            sd[p + name + ".bias"] = mat(n)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            w, b = _norm_pair(rng, E)
            sd[p + name + ".weight"] = torch.from_numpy(w)
            sd[p + name + ".bias"] = torch.from_numpy(b)
    cfg = SimpleNamespace(num_hidden_layers=L, max_position_embeddings=ctx,
                          hidden_size=E, intermediate_size=F,
                          num_attention_heads=H, layer_norm_eps=1e-12,
                          vocab_size=V)
    model = SimpleNamespace(config=cfg, state_dict=lambda: sd)
    hf_bert_to_gguf(model, path, level, wordpiece_metadata(V),
                    pooling_type=pooling_type, name=f"{preset}-{L}l-{level}")
    return path


def build_nomic_bert_gguf(path: str, preset: str = "nomic-embed-v1.5",
                          level: str = "q4_k_m", seed: int = 0,
                          widths: tuple | None = None) -> str:
    """A random nomic-bert at the preset's widths (or `widths`, a PRESETS
    tuple). level "q4_k_m" writes llama.cpp's mix (see the module
    docstring); any other level (f32, q8_0, q4_k_s, ...) every 2-D weight
    whose K is a multiple of 256 at that type, the rest f32. Tensors are
    made with numpy from `seed` and quantize in a thread pool."""
    L, E, H, F, V, ctx = widths or PRESETS[preset]
    w = GGUFWriter(path)
    arch = "nomic-bert"
    w.add("general.architecture", arch)
    w.add("general.name", f"{preset}-{L}l-{level}")
    for key, val in (("block_count", L), ("context_length", ctx),
                     ("embedding_length", E), ("feed_forward_length", F),
                     ("attention.head_count", H),
                     ("attention.layer_norm_epsilon", 1e-12),
                     ("attention.causal", False), ("pooling_type", 1),
                     ("rope.freq_base", 1000.0),
                     ("attention.token_type_count", 2)):
        w.add(f"{arch}.{key}", val)
    add_tokenizer_metadata(w, wordpiece_metadata(V))

    specs = [("token_embd.weight", (V, E)), ("token_types.weight", (2, E)),
             ("token_embd_norm.weight", (E,)), ("token_embd_norm.bias", (E,))]
    for i in range(L):
        p = f"blk.{i}."
        specs += [(p + "attn_q.weight", (E, E)), (p + "attn_k.weight", (E, E)),
                  (p + "attn_v.weight", (E, E)),
                  (p + "attn_output.weight", (E, E)),
                  (p + "attn_output_norm.weight", (E,)),
                  (p + "attn_output_norm.bias", (E,)),
                  (p + "ffn_up.weight", (F, E)), (p + "ffn_gate.weight", (F, E)),
                  (p + "ffn_down.weight", (E, F)),
                  (p + "layer_output_norm.weight", (E,)),
                  (p + "layer_output_norm.bias", (E,))]
    uniform = None if level == "q4_k_m" else QUANT_LEVEL_ALIASES[level]

    def make(j: int):
        name, shape = specs[j]
        rng = np.random.default_rng([seed, j])
        if len(shape) == 1:  # LayerNorm weight (about 1) or bias (about 0)
            arr = (name.endswith(".weight")
                   + 0.1 * rng.standard_normal(shape, dtype=np.float32))
            return GGMLType.F32, arr.astype(np.float32).tobytes()
        arr = 0.02 * rng.standard_normal(shape, dtype=np.float32)
        if name == "token_types.weight" or not _should_quantize(name, arr):
            ty = GGMLType.F32
        else:
            ty = q4km_type(name, L) if uniform is None else uniform
        if ty == GGMLType.F32:
            return ty, arr.tobytes()
        return ty, bytes(formats.quantize(arr.reshape(-1), ty))

    with cf.ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        for (name, shape), (ty, data) in zip(specs, ex.map(make, range(len(specs)))):
            w.add_tensor_raw(name, shape, ty, data)
    w.write()
    return path
