"""Plain PyTorch reference of the llama family as the benchmark's configs
name it (phi3, qwen2), in float32 with TF32 off.

It reads only the raw GGUF blocks that weights.draw_tensors makes from the
seed (the same bytes the program is served) and the configuration file,
and imports nothing of the program. The layer equations are the published
ones (Hugging Face's Phi3 and Qwen2 modelling code):

    h = RMSNorm(x); q, k, v = h Wq + bq, h Wk + bk, h Wv + bv
    q, k rotated by split-half (neox) rope at positions 0..T-1
    a = softmax(q k^T / sqrt(D) + causal / window mask) v   (grouped kv heads)
    x = x + a Wo; h = RMSNorm(x); x = x + (silu(h Wg) * h Wu) Wd
    logits = RMSNorm(x) Wout

phi3 stores q|k|v as one attn_qkv and gate|up as one ffn_up (gate first);
its 2047-token sliding window masks keys with q_pos - k_pos >= 2047.

dequantize() is the reference's own decoding of ggml's Q4_K, Q5_K and Q6_K
blocks (ggml-quants.c's dequantize_row_q*_K), and of F32.

`precision` "fp8" is the control: every matrix product takes x and W
rounded to float8 e4m3 with one scale per row (amax / 448), the step below
the bf16 operands the program's products take.

tensor_table() and gguf_metadata() give the GGUF file the benchmark
writes for such a configuration (weights.py, gguf_file.py): the tensors
in file order with llama.cpp's Q4_K_M types (llama_tensor_get_type), and
the metadata keys that llama.cpp reads for the architecture.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.gguf_file import F32, STRING, U32

GGML_F32, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K = 0, 12, 13, 14
_BLOCK_BYTES = {GGML_Q4_K: 144, GGML_Q5_K: 176, GGML_Q6_K: 210}


def use_more_bits(i: int, n: int) -> bool:
    """llama.cpp's layer rule for the Q6_K bump of attn_v / ffn_down."""
    return i < n // 8 or i >= 7 * n // 8 or (i - n // 8) % 3 == 2


def tensor_table(cfg: dict) -> list:
    """[(name, shape rows first, ggml type, draw)] in file order: phi3's
    fused q|k|v and gate|up, qwen2's q, k, v biases. 2-D weights are Q4_K;
    output.weight is Q6_K; attn_v and ffn_down are Q6_K on the layers where
    use_more_bits(i, n) holds; a fused attn_qkv is Q5_K; norms ("norm") and
    biases ("bias") are F32."""
    E, F, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    H, KH = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    L = cfg["num_hidden_layers"]
    D = E // H
    q, kv = H * D, KH * D
    g = cfg["gguf"]
    t = [("token_embd.weight", (V, E), GGML_Q4_K, "weight"),
         ("output_norm.weight", (E,), GGML_F32, "norm"),
         ("output.weight", (V, E), GGML_Q6_K, "weight")]
    for i in range(L):
        p = f"blk.{i}."
        more = use_more_bits(i, L)
        t.append((p + "attn_norm.weight", (E,), GGML_F32, "norm"))
        if g["fused_qkv"]:
            t.append((p + "attn_qkv.weight", (q + 2 * kv, E), GGML_Q5_K, "weight"))
        else:
            t += [(p + "attn_q.weight", (q, E), GGML_Q4_K, "weight"),
                  (p + "attn_k.weight", (kv, E), GGML_Q4_K, "weight"),
                  (p + "attn_v.weight", (kv, E),
                   GGML_Q6_K if more else GGML_Q4_K, "weight")]
        if g["qkv_bias"]:
            t += [(p + "attn_q.bias", (q,), GGML_F32, "bias"),
                  (p + "attn_k.bias", (kv,), GGML_F32, "bias"),
                  (p + "attn_v.bias", (kv,), GGML_F32, "bias")]
        t += [(p + "attn_output.weight", (E, q), GGML_Q4_K, "weight"),
              (p + "ffn_norm.weight", (E,), GGML_F32, "norm")]
        if g["fused_gate_up"]:
            t.append((p + "ffn_up.weight", (2 * F, E), GGML_Q4_K, "weight"))
        else:
            t += [(p + "ffn_gate.weight", (F, E), GGML_Q4_K, "weight"),
                  (p + "ffn_up.weight", (F, E), GGML_Q4_K, "weight")]
        t.append((p + "ffn_down.weight", (E, F),
                  GGML_Q6_K if more else GGML_Q4_K, "weight"))
    return t


def gguf_metadata(cfg: dict) -> list:
    """(key, type, value) entries of the architecture: one head_count_kv,
    key_length = hidden_size / heads, the sliding window where it is on."""
    a = cfg["gguf"]["architecture"]
    E, H = cfg["hidden_size"], cfg["num_attention_heads"]
    D = E // H
    md = [
        ("general.architecture", STRING, a),
        ("general.name", STRING, f"bench-{a}-{cfg['num_hidden_layers']}l-q4_k_m"),
        (f"{a}.block_count", U32, cfg["num_hidden_layers"]),
        (f"{a}.context_length", U32, cfg["max_position_embeddings"]),
        (f"{a}.embedding_length", U32, E),
        (f"{a}.feed_forward_length", U32, cfg["intermediate_size"]),
        (f"{a}.attention.head_count", U32, H),
        (f"{a}.attention.head_count_kv", U32, cfg["num_key_value_heads"]),
        (f"{a}.attention.layer_norm_rms_epsilon", F32, cfg["rms_norm_eps"]),
        (f"{a}.rope.freq_base", F32, cfg["rope_theta"]),
        (f"{a}.rope.dimension_count", U32, D),
        (f"{a}.attention.key_length", U32, D),
        (f"{a}.vocab_size", U32, cfg["vocab_size"]),
    ]
    if cfg.get("sliding_window") and cfg.get("use_sliding_window", True):
        md.append((f"{a}.attention.sliding_window", U32, cfg["sliding_window"]))
    return md


def _f16(b: torch.Tensor) -> torch.Tensor:
    """[nb, 2] uint8 -> [nb, 1] f32."""
    return b.contiguous().view(torch.float16).to(torch.float32)


def _scale_min_k4(s: torch.Tensor):
    """ggml's get_scale_min_k4 for j = 0..7: ([nb, 8] scales, [nb, 8] mins)."""
    s = s.to(torch.int32)
    sc_lo, m_lo = s[:, 0:4] & 63, s[:, 4:8] & 63
    sc_hi = (s[:, 8:12] & 0x0F) | ((s[:, 0:4] >> 6) << 4)
    m_hi = (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)
    return (torch.cat([sc_lo, sc_hi], 1).to(torch.float32),
            torch.cat([m_lo, m_hi], 1).to(torch.float32))


def dequantize(raw: torch.Tensor, ty: int, shape: tuple) -> torch.Tensor:
    """Raw block bytes (flat uint8) of one tensor -> f32 of `shape`."""
    if ty == GGML_F32:
        return raw.contiguous().view(torch.float32).reshape(shape).clone()
    blk = raw.reshape(-1, _BLOCK_BYTES[ty])
    nb = blk.shape[0]
    if ty == GGML_Q6_K:
        ql = blk[:, 0:128].to(torch.int32).reshape(nb, 2, 64)
        qh = blk[:, 128:192].to(torch.int32).reshape(nb, 2, 32)
        sc = blk[:, 192:208].contiguous().view(torch.int8).to(torch.float32)
        d = _f16(blk[:, 208:210])
        q1 = (ql[:, :, :32] & 0xF) | ((qh & 3) << 4)
        q2 = (ql[:, :, 32:] & 0xF) | (((qh >> 2) & 3) << 4)
        q3 = (ql[:, :, :32] >> 4) | (((qh >> 4) & 3) << 4)
        q4 = (ql[:, :, 32:] >> 4) | (((qh >> 6) & 3) << 4)
        q = torch.stack([q1, q2, q3, q4], 2).to(torch.float32) - 32  # [nb,2,4,32]
        # scale index of element (n, part, l): 8n + 2 * part + l // 16
        sc = sc.reshape(nb, 2, 8)
        part = torch.arange(4, device=raw.device)
        idx = (2 * part[:, None] + torch.arange(32, device=raw.device)[None, :] // 16)
        scl = sc[:, :, idx]  # [nb, 2, 4, 32]
        y = d[:, :, None, None] * scl * q
        return y.reshape(shape)
    d, dmin = _f16(blk[:, 0:2]), _f16(blk[:, 2:4])
    sc, m = _scale_min_k4(blk[:, 4:16])
    if ty == GGML_Q4_K:
        qs = blk[:, 16:144].to(torch.int32).reshape(nb, 4, 32)
        lo, hi = qs & 0xF, qs >> 4
    else:  # Q5_K
        qh = blk[:, 16:48].to(torch.int32)  # [nb, 32]
        qs = blk[:, 48:176].to(torch.int32).reshape(nb, 4, 32)
        c = torch.arange(4, device=raw.device)[None, :, None]
        lo = (qs & 0xF) + ((qh[:, None, :] >> (2 * c)) & 1) * 16
        hi = (qs >> 4) + ((qh[:, None, :] >> (2 * c + 1)) & 1) * 16
    q = torch.stack([lo, hi], 2).to(torch.float32).reshape(nb, 8, 32)
    y = (d * sc)[:, :, None] * q - (dmin * m)[:, :, None]
    return y.reshape(shape)


def _fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per row (last dim)."""
    amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    s = amax / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Reference:
    """The model of one configuration over raw tensors {name: (shape, type,
    flat uint8 bytes)} on one device."""

    def __init__(self, cfg: dict, raw: dict, precision: str = "f32"):
        self.cfg, self.raw, self.precision = cfg, raw, precision
        self.E = cfg["hidden_size"]
        self.H, self.KH = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        self.D = self.E // self.H
        self.F = cfg["intermediate_size"]
        self.eps = float(cfg["rms_norm_eps"])
        sw = cfg.get("sliding_window") if cfg.get("use_sliding_window", True) else 0
        self.window = int(sw or 0)

    def w(self, name: str) -> torch.Tensor:
        shape, ty, data = self.raw[name]
        return dequantize(data, ty, shape)

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        shape, ty, data = self.raw["token_embd.weight"]
        row_bytes = data.numel() // shape[0]
        rows = data.reshape(shape[0], row_bytes)[ids]
        return dequantize(rows.reshape(-1), ty, (len(ids), shape[1]))

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            x, w = _fp8_rows(x), _fp8_rows(w)
        return x @ w.t()

    def rms(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * w

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """x [T, heads, D], split-half rotation at positions 0..T-1."""
        T, D = x.shape[0], self.D
        half = D // 2
        inv = float(self.cfg["rope_theta"]) ** (
            -torch.arange(half, dtype=torch.float64, device=x.device) / half)
        ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv
        cos = torch.cos(ang).to(torch.float32)[:, None, :]
        sin = torch.sin(ang).to(torch.float32)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def attention(self, q, k, v) -> torch.Tensor:
        """q [T, H, D], k, v [T, KH, D] -> [T, H * D]."""
        T = q.shape[0]
        G = self.H // self.KH
        k = k.repeat_interleave(G, dim=1)
        v = v.repeat_interleave(G, dim=1)
        pos = torch.arange(T, device=q.device)
        allowed = pos[None, :] <= pos[:, None]
        if self.window > 0:
            allowed &= pos[None, :] > pos[:, None] - self.window
        out = torch.empty((T, self.H, self.D), dtype=torch.float32, device=q.device)
        for h0 in range(0, self.H, 8):  # heads in groups: bounded memory
            hs = slice(h0, h0 + 8)
            s = torch.einsum("thd,uhd->htu", q[:, hs], k[:, hs]) / math.sqrt(self.D)
            s = s.masked_fill(~allowed[None], float("-inf"))
            p = torch.softmax(s, dim=-1)
            out[:, hs] = torch.einsum("htu,uhd->thd", p, v[:, hs])
        return out.reshape(T, self.H * self.D)

    def layer(self, i: int, xs: list) -> list:
        p = f"blk.{i}."
        g = self.cfg["gguf"]
        q_rows, kv_rows = self.H * self.D, self.KH * self.D
        if g["fused_qkv"]:
            wqkv = self.w(p + "attn_qkv.weight")
            wq, wk, wv = wqkv.split([q_rows, kv_rows, kv_rows], 0)
        else:
            wq, wk, wv = (self.w(p + n + ".weight")
                          for n in ("attn_q", "attn_k", "attn_v"))
        bias = ([self.w(p + n + ".bias") for n in ("attn_q", "attn_k", "attn_v")]
                if g["qkv_bias"] else None)
        wo = self.w(p + "attn_output.weight")
        if g["fused_gate_up"]:
            wg, wu = self.w(p + "ffn_up.weight").split([self.F, self.F], 0)
        else:
            wg, wu = self.w(p + "ffn_gate.weight"), self.w(p + "ffn_up.weight")
        wd = self.w(p + "ffn_down.weight")
        an, fn = self.w(p + "attn_norm.weight"), self.w(p + "ffn_norm.weight")
        out = []
        for x in xs:
            T = x.shape[0]
            h = self.rms(x, an)
            q, k, v = self.linear(h, wq), self.linear(h, wk), self.linear(h, wv)
            if bias is not None:
                q, k, v = q + bias[0], k + bias[1], v + bias[2]
            q = self.rope(q.reshape(T, self.H, self.D))
            k = self.rope(k.reshape(T, self.KH, self.D))
            a = self.attention(q, k, v.reshape(T, self.KH, self.D))
            x = x + self.linear(a, wo)
            h = self.rms(x, fn)
            x = x + self.linear(F.silu(self.linear(h, wg)) * self.linear(h, wu), wd)
            out.append(x)
        return out

    @torch.no_grad()
    def logits(self, seqs: list, spans: list) -> list:
        """seqs: token id lists; spans: (lo, hi) per sequence. Returns, per
        sequence, f32 logits [hi - lo, V] at positions lo..hi-1 (the
        logits that predict tokens lo+1..hi)."""
        dev = self.raw["output.weight"][2].device
        xs = [self.embed(torch.tensor(s, dtype=torch.long, device=dev))
              for s in seqs]
        for i in range(self.cfg["num_hidden_layers"]):
            xs = self.layer(i, xs)
        on = self.w("output_norm.weight")
        wout = self.w("output.weight")
        return [self.linear(self.rms(x[lo:hi], on), wout)
                for x, (lo, hi) in zip(xs, spans)]
