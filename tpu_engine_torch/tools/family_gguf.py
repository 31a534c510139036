"""Random-weight GGUFs of four causal families at their published widths.

Each family's widths and hyperparameters are those of its config.json on
the Hugging Face hub (FAMILIES names the model; nothing is downloaded).
Only the depth is cut. Metadata keys and tensor names are the ones
tools/convert.hf_llama_to_gguf writes for the architecture, so both
model/config.py and the JAX package's config read them:

  - gemma2 (google/gemma-2-9b): head_dim 256, attention and final
    softcaps, query_pre_attn_scalar, a 4096-token window on alternate
    layers, post-attention and post-ffn norms, no output.weight (the head
    is tied to token_embd); norms stored as w - 1;
  - qwen2 (Qwen/Qwen2-7B-Instruct): q/k/v biases, 7 query heads per kv
    head, rope base 1e6;
  - phi3 (microsoft/Phi-3-mini-4k-instruct): fused attn_qkv and gate|up
    (ffn_up of 2 * n_ff rows), head_dim 96, a 2047-token window;
  - llama3.1 (meta-llama/Llama-3.1-8B-Instruct): rope_freqs.weight from
    the llama3 rule (convert.llama3_rope_factors), rope base 5e5.

Types follow llama.cpp's Q4_K_M rule (llama_tensor_get_type): 2-D
weights are Q4_K; the head is Q6_K (and token_embd is, when the head is
tied to it); attn_v and ffn_down are Q6_K where use_more_bits(i, n)
holds; a fused attn_qkv is Q5_K; norms, biases and rope_freqs are F32.

Weights are random: each k-quant block is drawn directly, its quants
uniform and its sub-block scales and mins set so the weights of a group
average about 0 with a spread about 0.02 (drawing floats and quantizing
them in numpy costs many times as much, for no other gain). The draws
come from numpy generators seeded by (family, seed, tensor index,
row chunk), so a file depends on nothing but those, and chunks are made
in a thread pool. tools/q4km.build_q4km_gguf (the Llama-2 smoke model)
is a separate writer: nothing here draws from its generators.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import zlib
from dataclasses import dataclass, replace

import numpy as np

from ..gguf.constants import GGMLType
from ..gguf.writer import GGUFWriter
from ..quant.formats import pack_scale_min_k4
from .convert import add_tokenizer_metadata, llama3_rope_factors
from .q4km import q4km_type
from .synthetic import tokenizer_metadata


@dataclass(frozen=True)
class Widths:
    n_layer: int
    n_embd: int
    n_head: int
    n_kv_head: int
    head_dim: int
    n_ff: int
    n_vocab: int


@dataclass(frozen=True)
class Family:
    source: str         # the Hugging Face model whose config.json this is
    arch: str           # general.architecture
    widths: Widths      # published widths (n_layer: the published depth)
    n_ctx_train: int
    rms_eps: float
    rope_theta: float
    extra: tuple = ()   # (key, value): arch metadata beyond the common keys
    llama3_rope: tuple = ()  # (factor, low, high, original context)


FAMILIES = {
    "gemma2": Family(
        "google/gemma-2-9b", "gemma2",
        Widths(42, 3584, 16, 8, 256, 14336, 256000), 8192, 1e-6, 10000.0,
        extra=(("attn_logit_softcapping", 50.0),
               ("final_logit_softcapping", 30.0),
               ("attention.sliding_window", 4096),
               ("attention.query_pre_attn_scalar", 256.0))),
    "qwen2": Family(
        "Qwen/Qwen2-7B-Instruct", "qwen2",
        Widths(28, 3584, 28, 4, 128, 18944, 152064), 32768, 1e-6, 1e6),
    "phi3": Family(
        "microsoft/Phi-3-mini-4k-instruct", "phi3",
        Widths(32, 3072, 32, 32, 96, 8192, 32064), 4096, 1e-5, 10000.0,
        extra=(("attention.sliding_window", 2047),)),
    "llama3.1": Family(
        "meta-llama/Llama-3.1-8B-Instruct", "llama",
        Widths(32, 4096, 32, 8, 128, 14336, 128256), 131072, 1e-5, 500000.0,
        llama3_rope=(8.0, 1.0, 4.0, 8192)),
}
CHUNK = 1 << 24  # weights drawn per task
SPREAD = 0.02    # about the std of a drawn weight


def family_type(name: str, n_layer: int, tied: bool) -> GGMLType:
    """llama.cpp's Q4_K_M type of a 2-D weight: q4km_type's rule, plus the
    tied head's Q6_K on token_embd and Q5_K on a fused attn_qkv."""
    if name == "token_embd.weight":
        return GGMLType.Q6_K if tied else GGMLType.Q4_K
    if name.endswith(".attn_qkv.weight"):
        return GGMLType.Q5_K
    return q4km_type(name, n_layer)


def random_blocks(rng: np.random.Generator, n: int, ty: GGMLType) -> bytes:
    """n weights (a multiple of 256) as random blocks of a k-quant type.
    Q6_K: w = d * sc * (q - 32), q uniform on 0..63, sc on +-[8, 24].
    Q4_K / Q5_K: w = d * sc * q - dmin * m, q uniform on 0..qmax, sc on
    [lo, hi], dmin = d * (qmax + 1) / 2 and m = rint(sc * qmax / (qmax +
    1)), so each sub-block's mean is about 0. d sets the spread to
    SPREAD."""
    nb = n // 256
    if ty == GGMLType.Q6_K:
        blk = np.empty((nb, 210), np.uint8)
        blk[:, :192] = rng.integers(0, 256, (nb, 192), dtype=np.uint8)
        sc = rng.integers(8, 25, (nb, 16)) * (2 * rng.integers(0, 2, (nb, 16)) - 1)
        blk[:, 192:208] = sc.astype(np.int8).view(np.uint8)
        d = SPREAD / (16 * 18.47)  # mean |sc|, std of q - 32
        blk[:, 208:210] = np.full((nb, 1), d, np.float16).view(np.uint8)
        return blk.tobytes()
    qmax, lo, hi, size = ((15, 32, 63, 144) if ty == GGMLType.Q4_K
                          else (31, 24, 40, 176))
    d = SPREAD / ((lo + hi) / 2 * np.sqrt(((qmax + 1) ** 2 - 1) / 12))
    sc = rng.integers(lo, hi + 1, (nb, 8))
    blk = np.empty((nb, size), np.uint8)
    blk[:, 0:2] = np.full((nb, 1), d, np.float16).view(np.uint8)
    blk[:, 2:4] = np.full((nb, 1), d * (qmax + 1) / 2, np.float16).view(np.uint8)
    blk[:, 4:16] = pack_scale_min_k4(sc, np.rint(sc * qmax / (qmax + 1)))
    blk[:, 16:] = rng.integers(0, 256, (nb, size - 16), dtype=np.uint8)
    return blk.tobytes()


def family_metadata(family: str, n_layer: int, widths: Widths | None = None) -> dict:
    """The file's metadata (tokenizer included) for `family` at n_layer
    layers and the published widths (or `widths`)."""
    fam = FAMILIES[family]
    w = widths or fam.widths
    a = fam.arch
    md = {"general.architecture": a,
          "general.name": f"{family}-{n_layer}l-q4_k_m",
          f"{a}.block_count": n_layer,
          f"{a}.context_length": fam.n_ctx_train,
          f"{a}.embedding_length": w.n_embd,
          f"{a}.feed_forward_length": w.n_ff,
          f"{a}.attention.head_count": w.n_head,
          f"{a}.attention.head_count_kv": w.n_kv_head,
          f"{a}.attention.layer_norm_rms_epsilon": fam.rms_eps,
          f"{a}.rope.freq_base": fam.rope_theta,
          f"{a}.rope.dimension_count": w.head_dim,
          f"{a}.attention.key_length": w.head_dim,
          f"{a}.vocab_size": w.n_vocab}
    md.update((f"{a}.{k}", v) for k, v in fam.extra)
    md.update(tokenizer_metadata(w.n_vocab))
    return md


def tensor_specs(family: str, n_layer: int, widths: Widths | None = None) -> list:
    """(name, shape) of every tensor, in file order; shapes are numpy's
    (rows = output features)."""
    fam = FAMILIES[family]
    w = widths or fam.widths
    E, D, F = w.n_embd, w.head_dim, w.n_ff
    q, kv = w.n_head * D, w.n_kv_head * D
    specs = [("token_embd.weight", (w.n_vocab, E)), ("output_norm.weight", (E,))]
    if fam.arch != "gemma2":
        specs.append(("output.weight", (w.n_vocab, E)))
    if fam.llama3_rope:
        specs.append(("rope_freqs.weight", (D // 2,)))
    for i in range(n_layer):
        p = f"blk.{i}."
        specs.append((p + "attn_norm.weight", (E,)))
        if fam.arch == "phi3":
            specs.append((p + "attn_qkv.weight", (q + 2 * kv, E)))
        else:
            specs += [(p + "attn_q.weight", (q, E)), (p + "attn_k.weight", (kv, E)),
                      (p + "attn_v.weight", (kv, E))]
        if fam.arch == "qwen2":
            specs += [(p + "attn_q.bias", (q,)), (p + "attn_k.bias", (kv,)),
                      (p + "attn_v.bias", (kv,))]
        specs += [(p + "attn_output.weight", (E, q)), (p + "ffn_norm.weight", (E,))]
        if fam.arch == "phi3":
            specs.append((p + "ffn_up.weight", (2 * F, E)))
        else:
            specs += [(p + "ffn_gate.weight", (F, E)), (p + "ffn_up.weight", (F, E))]
        specs.append((p + "ffn_down.weight", (E, F)))
        if fam.arch == "gemma2":
            specs += [(p + "post_attention_norm.weight", (E,)),
                      (p + "post_ffw_norm.weight", (E,))]
    return specs


def build_family_gguf(path: str, family: str, n_layer: int = 2, seed: int = 0,
                      widths: Widths | None = None,
                      threads: int | None = None) -> str:
    """Write `family` at its published widths (or `widths`, whose n_layer
    is ignored) cut to n_layer layers, at the Q4_K_M mix."""
    fam = FAMILIES[family]
    w = replace(widths or fam.widths, n_layer=n_layer)
    md = family_metadata(family, n_layer, w)
    specs = tensor_specs(family, n_layer, w)
    tied = fam.arch == "gemma2"
    fam_id = zlib.crc32(family.encode())
    out = GGUFWriter(path)
    tok = {k: v for k, v in md.items() if k.startswith("tokenizer.")}
    for k, v in md.items():
        if k not in tok:
            out.add(k, v)
    add_tokenizer_metadata(out, tok)

    # tasks: (tensor index, first row, end row); 1-D tensors are one task
    tasks = []
    for j, (name, shape) in enumerate(specs):
        rows = max(1, CHUNK // shape[-1]) if len(shape) == 2 else shape[0]
        tasks += [(j, r, min(r + rows, shape[0])) for r in range(0, shape[0], rows)]

    def make(task):
        j, r0, r1 = task
        name, shape = specs[j]
        rng = np.random.default_rng([fam_id, seed, j, r0])
        if name == "rope_freqs.weight":
            return llama3_rope_factors(w.head_dim, fam.rope_theta,
                                       *fam.llama3_rope).tobytes()
        if len(shape) == 1:
            noise = 0.1 * rng.standard_normal(shape, dtype=np.float32)
            if name.endswith(".bias"):
                return noise.tobytes()
            # gemma stores norm weights as w - 1 (the loaders add one)
            return (noise + (0.0 if tied else 1.0)).astype(np.float32).tobytes()
        return random_blocks(rng, (r1 - r0) * shape[1],
                             family_type(name, n_layer, tied))

    parts: list[list[bytes]] = [[] for _ in specs]
    with cf.ThreadPoolExecutor(max_workers=threads or os.cpu_count() or 1) as ex:
        for (j, _, _), data in zip(tasks, ex.map(make, tasks)):
            parts[j].append(data)
    for j, (name, shape) in enumerate(specs):
        ty = (family_type(name, n_layer, tied) if len(shape) == 2
              else GGMLType.F32)
        out.add_tensor_raw(name, shape, ty, b"".join(parts[j]))
        parts[j] = []
    out.write()
    return path
