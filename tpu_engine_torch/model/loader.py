"""GGUF -> device weights loader (PyTorch port).

Parses the GGUF, uploads each quantized tensor's raw block bytes and
extracts them on the device into the natural layout (model/weights.
extract_staged: the CUDA kernel of kernels/extract.py on the card, the
numpy quant/device_format.py on the CPU), fuses q|k|v and
gate|up along N where the parts share a format (concat_qtensors), and
builds the tokenizer and config. "norm"-rope models are converted to
split-half ("neox") rotation by de-interleaving the q/k projection rows
(exact; scores are invariant). Non-causal GGUFs (bert, nomic-bert) load
into the encoder layout that model/bert.py reads (_load_encoder).

The layers stay a per-layer list: the port runs them in a Python loop.

sharder(name, tensor) -> tensor (dist/tp.TPSharder) cuts each weight and
q/k/v bias to one tensor-parallel rank's slice. A weight is extracted
whole on the rank's own device and then cut (a rank's K-slice of w_down
need not lie on block edges, so raw bytes cannot be cut by columns); the
whole tensor is freed before the next one, so a rank holds at most one
whole tensor beyond its slices, never the whole model. A stored fused
attn_qkv or gate|up (phi3) is first cut back into its q, k, v or gate, up
rows, as the JAX loader does, and each part sliced like an unfused
tensor; q|k|v and gate|up are then fused from the rank's own slices.

The log line of a load gives its split (LoadedModel.load_split, seconds):
read (header and config), tokenizer, stage (host copies into the staging
buffers), upload and extract (device time on the card), dense (tensors
dequantized by numpy), permute_fuse (row permutation, fusion, sharding),
norms, and the total wall time.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..gguf.reader import GGUFFile, read_gguf
from ..tokenizer.tokenizer import Tokenizer
from ..utils.device import resolve_device
from .config import ModelConfig
from .weights import (LoadSplit, QTensor, concat_qtensors, permute_rows,
                      qtensor_from_gguf)

log = logging.getLogger("tpu_engine.loader")


@dataclass
class LoadedModel:
    cfg: ModelConfig
    tokenizer: Tokenizer
    weights: dict
    model_size_bytes: int
    metadata: dict = field(default_factory=dict)
    device: torch.device = torch.device("cpu")
    load_split: dict = field(default_factory=dict)  # phase -> seconds


def deinterleave_rope_perm(n_head: int, head_dim: int, rope_dim: int) -> np.ndarray:
    """Row permutation turning "norm" (interleaved-pair) rope projections
    into "neox" (split-half) layout: within each head, row d (d < rd/2)
    takes old row 2d, row d + rd/2 takes old row 2d+1; rows past rope_dim
    stay."""
    half = rope_dim // 2
    p = np.arange(head_dim)
    p[:half] = 2 * np.arange(half)
    p[half:rope_dim] = 2 * np.arange(half) + 1
    return (np.arange(n_head)[:, None] * head_dim + p[None, :]).reshape(-1)


def _norm(g: GGUFFile, name: str, device, dtype, add_one: bool = False):
    w = np.asarray(g.dequantize(name, np.float32))
    if add_one:
        w = w + 1.0  # gemma convention: weights stored as (w - 1)
    return torch.from_numpy(np.ascontiguousarray(w)).to(device=device, dtype=dtype)


def _vec(g: GGUFFile, name: str, device, dtype, perm=None, sharder=None):
    w = np.asarray(g.dequantize(name, np.float32))
    if perm is not None:
        w = w[perm]
    t = torch.from_numpy(np.ascontiguousarray(w))
    if sharder is not None:
        t = sharder(name, t)
    return t.to(device=device, dtype=dtype)


def _load_encoder(g: GGUFFile, cfg: ModelConfig, dev,
                  compute_dtype, split: LoadSplit) -> dict:
    """bert / nomic-bert tensor layout (llama.cpp's encoder conventions;
    model/bert.py reads this dict). Every LayerNorm carries a bias; the
    separate attn_q/k/v and the other projections may (bert) or may not
    (nomic-bert) carry one; ffn_gate exists only for nomic-bert."""

    def vec(name):
        with split.phase("norms"):
            return _vec(g, name, dev, compute_dtype)

    def dense(lw, key, gname):
        lw[key] = qtensor_from_gguf(g, gname + ".weight", dev, compute_dtype,
                                    split)
        if gname + ".bias" in g.tensors:
            lw[key + "_b"] = vec(gname + ".bias")

    weights = {
        "token_embd": qtensor_from_gguf(g, "token_embd.weight", dev,
                                        compute_dtype, split),
        "token_embd_norm": vec("token_embd_norm.weight"),
        "token_embd_norm_b": vec("token_embd_norm.bias"),
        "layers": [],
    }
    for name in ("token_types", "position_embd"):
        if name + ".weight" in g.tensors:
            weights[name] = vec(name + ".weight")
    for i in range(cfg.n_layer):
        p = f"blk.{i}."
        lw = {
            "attn_norm": vec(p + "attn_output_norm.weight"),
            "attn_norm_b": vec(p + "attn_output_norm.bias"),
            "ffn_norm": vec(p + "layer_output_norm.weight"),
            "ffn_norm_b": vec(p + "layer_output_norm.bias"),
        }
        for key, gname in (("wq", "attn_q"), ("wk", "attn_k"), ("wv", "attn_v"),
                           ("wo", "attn_output"), ("w_up", "ffn_up"),
                           ("w_down", "ffn_down")):
            dense(lw, key, p + gname)
        if p + "ffn_gate.weight" in g.tensors:  # nomic-bert SwiGLU
            dense(lw, "w_gate", p + "ffn_gate")
        weights["layers"].append(lw)
    return weights


def load_model(path: str, device=None, compute_dtype=torch.float32,
               sharder=None) -> LoadedModel:
    """Load a GGUF model onto `device` (default "cuda"; raises when CUDA is
    missing and the CPU was not asked for). A causal model gets the
    llama-family layout, a non-causal one the encoder layout. sharder: a
    tensor-parallel rank's loader hook (dist/tp.TPSharder); an encoder
    ignores it (served whole, as the JAX package's encoder path does)."""
    dev = resolve_device(device)
    t0 = time.time()
    split = LoadSplit(dev)

    def loaded(what: str, **kw) -> LoadedModel:
        secs = split.seconds()
        secs["total"] = time.time() - t0
        log.info("loaded %s %s onto %s in %.1fs (%s)", what, path, dev,
                 secs["total"], ", ".join(f"{k} {v:.2f}s"
                                          for k, v in secs.items()
                                          if k != "total"))
        return LoadedModel(cfg=cfg, tokenizer=tok, model_size_bytes=size,
                           metadata=dict(g.metadata), device=dev,
                           load_split=secs, **kw)

    with split.phase("read"):
        g = read_gguf(path)
    try:
        with split.phase("read"):
            cfg = ModelConfig.from_gguf_metadata(g.metadata)
            if "rope_freqs.weight" in g.tensors:
                cfg.rope_freqs = tuple(
                    float(x) for x in
                    np.asarray(g.dequantize("rope_freqs.weight", np.float32)))
            size = sum(t.n_bytes for t in g.tensors.values())
        with split.phase("tokenizer"):
            tok = Tokenizer.from_gguf_metadata(g.metadata)
        if not cfg.causal:
            return loaded("encoder", weights=_load_encoder(
                g, cfg, dev, compute_dtype, split))
        add_one = cfg.arch.startswith("gemma")

        qk_perm = None
        if cfg.rope_type == "norm":
            qk_perm = {
                "q": deinterleave_rope_perm(cfg.n_head, cfg.head_dim, cfg.rope_dim),
                "k": deinterleave_rope_perm(cfg.n_kv_head, cfg.head_dim, cfg.rope_dim),
            }
            cfg.rope_type = "neox"

        def qt(name: str) -> QTensor:
            t = qtensor_from_gguf(g, name, dev, compute_dtype, split)
            with split.phase("permute_fuse"):
                if qk_perm is not None and name.endswith((".attn_q.weight",
                                                          ".attn_k.weight")):
                    t = permute_rows(t, qk_perm["q" if "attn_q" in name
                                                else "k"])
                return t if sharder is None else sharder(name, t)

        def cut_fused(name: str, parts: list) -> list:
            """A stored fused weight cut by rows into parts [(GGUF name of
            the part, rows)], each then sharded as that unfused tensor
            (under a sharder only: the rank's heads of q, k and v, or its
            rows of gate and up, are not one contiguous slice)."""
            from ..dist.sharding import slice_rows

            t = qtensor_from_gguf(g, name, dev, compute_dtype, split)
            if sum(n for _, n in parts) != t.shape[0]:
                raise ValueError(f"{name}: {t.shape[0]} rows, not the parts "
                                 f"{parts}")
            out, n0 = [], 0
            with split.phase("permute_fuse"):
                for part, n in parts:
                    out.append(sharder(part, slice_rows(t, n0, n0 + n)))
                    n0 += n
            return out

        H, KH, D = cfg.n_head, cfg.n_kv_head, cfg.head_dim

        def vec(name: str, perm=None):
            with split.phase("norms"):
                return _vec(g, name, dev, compute_dtype, perm, sharder)

        def norm(name: str):
            with split.phase("norms"):
                return _norm(g, name, dev, compute_dtype, add_one)

        def convert_layer(i: int) -> dict:
            p = f"blk.{i}."
            lw = {
                "attn_norm": norm(p + "attn_norm.weight"),
                "wo": qt(p + "attn_output.weight"),
                "ffn_norm": norm(p + "ffn_norm.weight"),
                "w_down": qt(p + "ffn_down.weight"),
            }
            if p + "attn_qkv.weight" in g.tensors:  # phi3-style fused qkv
                if sharder is None:
                    lw["wqkv"] = qt(p + "attn_qkv.weight")
                else:
                    lw["wq"], lw["wk"], lw["wv"] = cut_fused(
                        p + "attn_qkv.weight", [(p + "attn_q.weight", H * D),
                                                (p + "attn_k.weight", KH * D),
                                                (p + "attn_v.weight", KH * D)])
            else:
                lw["wq"] = qt(p + "attn_q.weight")
                lw["wk"] = qt(p + "attn_k.weight")
                lw["wv"] = qt(p + "attn_v.weight")
            if p + "ffn_gate.weight" in g.tensors:
                lw["w_gate"] = qt(p + "ffn_gate.weight")
                lw["w_up"] = qt(p + "ffn_up.weight")
            elif sharder is None:  # phi3-style fused gate|up stored as ffn_up
                lw["w_gateup"] = qt(p + "ffn_up.weight")
            else:
                lw["w_gate"], lw["w_up"] = cut_fused(
                    p + "ffn_up.weight", [(p + "ffn_gate.weight", cfg.n_ff),
                                          (p + "ffn_up.weight", cfg.n_ff)])
            if p + "attn_q.bias" in g.tensors:
                lw["bq"] = vec(p + "attn_q.bias",
                               None if qk_perm is None else qk_perm["q"])
                lw["bk"] = vec(p + "attn_k.bias",
                               None if qk_perm is None else qk_perm["k"])
                lw["bv"] = vec(p + "attn_v.bias")
            with split.phase("permute_fuse"):
                fuse(lw)
            if p + "post_attention_norm.weight" in g.tensors:
                lw["post_attn_norm"] = norm(p + "post_attention_norm.weight")
                lw["post_ffn_norm"] = norm(p + "post_ffw_norm.weight")
            return lw

        def fuse(lw: dict) -> None:
            """q|k|v and gate|up fused along N where the formats match: one
            kernel launch instead of three/two (under a sharder, of the
            rank's slices: the same function on the rank's heads and
            rows)."""
            if "wq" in lw:
                fused = concat_qtensors([lw["wq"], lw["wk"], lw["wv"]])
                if fused is not None:
                    lw["wqkv"] = fused
                    del lw["wq"], lw["wk"], lw["wv"]
                    if "bq" in lw:
                        lw["bqkv"] = torch.cat([lw.pop("bq"), lw.pop("bk"),
                                                lw.pop("bv")])
            if "w_gate" in lw:
                fused = concat_qtensors([lw["w_gate"], lw["w_up"]])
                if fused is not None:
                    lw["w_gateup"] = fused
                    del lw["w_gate"], lw["w_up"]

        weights = {
            "token_embd": qt("token_embd.weight"),
            "output_norm": norm("output_norm.weight"),
            "layers": [convert_layer(i) for i in range(cfg.n_layer)],
        }
        if "output.weight" in g.tensors:
            weights["output"] = qt("output.weight")
        else:
            cfg.tie_embeddings = True
            weights["output"] = weights["token_embd"]
        return loaded("model", weights=weights)
    finally:
        g.close()
