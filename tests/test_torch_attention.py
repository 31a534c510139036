"""The port's attention (tpu_engine_torch model.llama.attention_reference and
kernels.flash_attention's CPU path) against the JAX package's
attention_reference and its Pallas flash_attention in interpret mode, with
K stored pre-rotated (rot_cache=True, the serving path without
self-extend; tests/test_torch_self_extend.py covers K stored unrotated),
for every path the JAX package routes to:
  - "td" cache, f32/f16 (bf16 cells), q8_0 and q4_0: _decode_kernel_bh
    (B3) and _prefill_kernel (B4);
  - "dt" cache, all four kinds: _decode_kernel_dma (B5, T a multiple of
    128), _decode_kernel_t (B6, T=160) and _prefill_kernel_t (B7).
Cases mirror tests/test_flash_attention.py: decode, prefill, continuation,
mixed lengths, slot indirection, GQA (TinyLlama's G=8 at D=64 included),
softcap, sliding window, ragged n_valid.

Inputs come from a numpy seed and go to both packages; quantized cells
are quantized once (JAX's quantize_kv_rows) and the same bytes go to both.
Tolerances:
  - port vs JAX reference: 2e-5 (both f32 throughout, both dequantize
    cell x scale in f32; only the order of f32 sums differs);
  - port vs Pallas interpret: 2e-5 where the TPU kernel computes in f32
    (f32 cells, and both prefill kernels on any cells), 2e-2 for decode on
    bf16/q8_0/q4_0 cells, where _decode_kernel_bh, _decode_kernel_dma and
    _decode_kernel_t round q and p to bf16 for their dots (~2^-8
    relative).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.kernels import flash_attention as JFA
from tpu_engine.kvcache.cache import KVCache as JKV
from tpu_engine.kvcache.cache import quantize_kv_rows
from tpu_engine.model.config import ModelConfig
from tpu_engine.model.llama import attention_reference as j_ref
from tpu_engine_torch.kernels import flash_attention as TFA
from tpu_engine_torch.kvcache.cache import KVCache as TKV
from tpu_engine_torch.model.llama import attention_reference as t_ref

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def interpret_mode():
    JFA._INTERPRET = True
    yield
    JFA._INTERPRET = False


def mk_cfg(H=4, KH=2, D=64, softcap=0.0, window=0, rope_dim=None):
    cfg = ModelConfig(
        arch="llama", n_layer=1, n_embd=H * D, n_head=H, n_kv_head=KH,
        head_dim=D, n_ff=16, n_vocab=32, rms_eps=1e-5, rope_dim=rope_dim or D,
        rope_type="neox", rope_theta=10000.0, n_ctx_train=2048,
        attn_logit_softcap=softcap)
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window,
                                  swa_alternate=False)
    return cfg


def _caches(kind, layout, k, v, lengths):
    """The same stored planes for both packages (k, v [1, B, KH, T, D] f32
    in "td" order; quantized once, with JAX's quantize_kv_rows)."""
    if kind in ("q8_0", "q4_0"):
        (kc, ks), (vc, vs) = (quantize_kv_rows(jnp.asarray(x), kind)
                              for x in (k, v))
        kc, vc, ks, vs = (np.asarray(a) for a in (kc, vc, ks, vs))
    else:
        ks = vs = None
        kc, vc = (np.asarray(jnp.asarray(x, jnp.float32 if kind == "f32"
                                         else jnp.bfloat16)) for x in (k, v))
    if layout == "dt":
        kc, vc = np.swapaxes(kc, -1, -2).copy(), np.swapaxes(vc, -1, -2).copy()
    jc = JKV(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lengths),
             None if ks is None else jnp.asarray(ks),
             None if vs is None else jnp.asarray(vs), kind, layout)

    def tt(a):  # a writable copy with the same bytes
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(np.array(a.view(np.int16))).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))

    tc = TKV(tt(kc), tt(vc), torch.from_numpy(lengths),
             None if ks is None else tt(ks), None if vs is None else tt(vs),
             kind=kind, layout=layout)
    return jc, tc


def make_inputs(kind, seed, B, Tc, T, starts, cfg, slot_perm=None,
                n_valid=None, layout="td", ga=(1, 0)):
    """The same operands for both packages: (JAX args, port args, n_valid)
    in attention_reference's order."""
    rng = np.random.default_rng(seed)
    H, KH, D = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    q = rng.standard_normal((B, Tc, H, D)).astype(np.float32)
    k = rng.standard_normal((1, B, KH, T, D)).astype(np.float32)
    v = rng.standard_normal((1, B, KH, T, D)).astype(np.float32)
    kn = rng.standard_normal((B, KH, Tc, D)).astype(np.float32)
    vn = rng.standard_normal((B, KH, Tc, D)).astype(np.float32)
    slots = np.arange(B, dtype=np.int32) if slot_perm is None else \
        np.asarray(slot_perm, np.int32)
    # row b reads slot slots[b], whose history length is starts[b]
    q_pos = np.asarray([[starts[b] + t for t in range(Tc)] for b in range(B)],
                       np.int32)
    nv = np.full((B,), Tc, np.int32) if n_valid is None else \
        np.asarray(n_valid, np.int32)
    lengths = np.zeros((B,), np.int32)
    lengths[slots] = starts
    jc, tc = _caches(kind, layout, k, v, lengths)
    jargs = (jnp.asarray(q), jc, 0, jnp.asarray(slots), jnp.asarray(q_pos),
             jnp.asarray(nv), jnp.asarray(kn), jnp.asarray(vn), cfg,
             jnp.int32(ga[0]), jnp.int32(ga[1]))
    targs = (torch.from_numpy(q), tc, 0, torch.from_numpy(slots),
             torch.from_numpy(q_pos), torch.from_numpy(nv),
             torch.from_numpy(kn), torch.from_numpy(vn), cfg, *ga)
    return jargs, targs, nv


def run_case(kind, seed, B, Tc, T, starts, cfg, slot_perm=None, n_valid=None,
             layout="td", ga=(1, 0), rot_cache=True):
    """Outputs of the JAX reference, the JAX Pallas kernel (interpret
    mode), the port's plain version and the port's flash_attention on the
    same inputs; ga = (ga_n, ga_w) of the self-extend remap, applied to
    cached K when rot_cache is False."""
    jargs, targs, nv = make_inputs(kind, seed, B, Tc, T, starts, cfg,
                                   slot_perm, n_valid, layout, ga)
    jr = np.asarray(j_ref(*jargs, rot_cache=rot_cache))
    jp = np.asarray(JFA.flash_attention(*jargs, rot_cache=rot_cache))
    tr = t_ref(*targs, rot_cache=rot_cache).numpy()
    tf = TFA.flash_attention(*targs, rot_cache=rot_cache).numpy()
    return jr, jp, tr, tf, nv


CASES = {
    # name: (B, Tc, T, starts, cfg kwargs, slot_perm, n_valid)
    "decode": (4, 1, 160, [157, 150, 100, 3], {}, None, None),
    "prefill": (2, 96, 160, [0, 0], {}, None, None),
    "continuation": (2, 32, 256, [40, 7], {}, None, None),
    "mixed_lengths": (4, 1, 640, [5, 130, 333, 639], {}, None, None),
    "slot_indirection": (3, 1, 128, [10, 40, 90], {}, [2, 0, 1], None),
    "gqa": (2, 8, 96, [17, 60], dict(H=8, KH=2), None, None),
    "softcap": (2, 8, 64, [3, 11], dict(H=2, KH=2, softcap=50.0), None, None),
    "window_decode": (3, 1, 160, [10, 60, 159], dict(window=24), None, None),
    "window_prefill": (2, 32, 256, [40, 100], dict(window=24), None, None),
    "ragged_n_valid": (2, 16, 64, [0, 20], {}, None, [16, 9]),
}


@pytest.mark.parametrize("kind", ["f32", "f16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_attention_matches_jax(case, kind):
    B, Tc, T, starts, ckw, perm, nv_in = CASES[case]
    cfg = mk_cfg(**ckw)
    jr, jp, tr, tf, nv = run_case(kind, sorted(CASES).index(case), B, Tc, T, starts,
                                  cfg, perm, nv_in)
    # rows past n_valid are padding in both packages: compare valid rows
    valid = np.arange(Tc)[None, :] < nv[:, None]
    np.testing.assert_allclose(tr[valid], jr[valid], rtol=2e-5, atol=2e-5)
    # the port's flash_attention on CPU tensors IS the plain version
    np.testing.assert_array_equal(tf, tr)
    tol = 2e-2 if (kind == "f16" and Tc == 1) else 2e-5
    np.testing.assert_allclose(tr[valid], jp[valid], rtol=tol, atol=tol)


def check_case(kind, layout, seed, B, Tc, T, starts, ckw, perm=None,
               nv_in=None):
    cfg = mk_cfg(**ckw)
    jr, jp, tr, tf, nv = run_case(kind, seed, B, Tc, T, starts, cfg, perm,
                                  nv_in, layout=layout)
    valid = np.arange(Tc)[None, :] < nv[:, None]
    np.testing.assert_allclose(tr[valid], jr[valid], rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(tf, tr)
    tol = 2e-2 if (kind != "f32" and Tc == 1) else 2e-5
    np.testing.assert_allclose(tr[valid], jp[valid], rtol=tol, atol=tol)


# B3/B4 on quantized "td" cells
QUANT_TD_CASES = ("decode", "prefill", "continuation", "gqa", "window_decode",
                  "ragged_n_valid")


@pytest.mark.parametrize("kind", ["q8_0", "q4_0"])
@pytest.mark.parametrize("case", QUANT_TD_CASES)
def test_quantized_td_matches_jax(case, kind):
    B, Tc, T, starts, ckw, perm, nv_in = CASES[case]
    check_case(kind, "td", 100 + QUANT_TD_CASES.index(case), B, Tc, T,
               starts, ckw, perm, nv_in)


DT_CASES = {
    # name: (B, Tc, T, starts, cfg kwargs, slot_perm, n_valid)
    # B5 (_decode_kernel_dma): T a multiple of 128, an empty row included
    "dma_decode": (4, 1, 256, [0, 5, 130, 255], {}, None, None),
    # B6 (_decode_kernel_t): T with no 128-multiple divisor
    "t_decode": (4, 1, 160, [157, 150, 100, 3], {}, None, None),
    # B7 (_prefill_kernel_t), with history
    "prefill": (2, 32, 256, [40, 7], {}, None, None),
    # TinyLlama geometry: G = 8 (attn_decode's limit) at D = 64
    "tinyllama_decode": (2, 1, 256, [200, 17], dict(H=16, KH=2), None, None),
    "tinyllama_prefill": (2, 16, 128, [0, 60], dict(H=16, KH=2), None, None),
}
DT_EXTRA_CASES = {
    "window_decode": (3, 1, 256, [10, 60, 200], dict(window=24), None, None),
    "window_prefill": (2, 32, 256, [40, 100], dict(window=24), None, None),
    "ragged_n_valid": (2, 16, 64, [0, 20], {}, None, [16, 9]),
    "slot_indirection": (3, 1, 128, [10, 40, 90], {}, [2, 0, 1], None),
    "softcap": (2, 8, 64, [3, 11], dict(H=2, KH=2, softcap=50.0), None, None),
}


@pytest.mark.parametrize("kind", ["f32", "f16", "q8_0", "q4_0"])
@pytest.mark.parametrize("case", list(DT_CASES))
def test_dt_matches_jax(case, kind):
    check_case(kind, "dt", 200 + list(DT_CASES).index(case),
               *DT_CASES[case])


@pytest.mark.parametrize("kind", ["q8_0", "q4_0"])
@pytest.mark.parametrize("case", list(DT_EXTRA_CASES))
def test_dt_quantized_masks_match_jax(case, kind):
    check_case(kind, "dt", 300 + list(DT_EXTRA_CASES).index(case),
               *DT_EXTRA_CASES[case])


# head shapes past the first slices' CUDA limits: Gemma's head_dim 256
# (G = 2) and 16 query heads per kv head
WIDE_CASES = {
    "d256_decode": (2, 1, 128, [100, 7], dict(H=4, KH=2, D=256), None, None),
    "d256_prefill": (2, 16, 128, [0, 40], dict(H=4, KH=2, D=256), None,
                     [16, 9]),
    "g16_decode": (2, 1, 128, [100, 7], dict(H=32, KH=2, D=64), None, None),
    "g16_prefill": (1, 8, 64, [20], dict(H=32, KH=2, D=64), None, None),
}


@pytest.mark.parametrize("kind,layout", [("f16", "td"), ("q8_0", "dt")])
@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_wide_heads_match_jax(case, kind, layout):
    check_case(kind, layout, 400 + list(WIDE_CASES).index(case),
               *WIDE_CASES[case])


# the CUDA prefill kernels' tile edges (attn_common.cuh: 64-cell tiles at
# D <= 128, 32 at D = 256; chip_smoke.py prefill_edge_checks): histories 0,
# 1, 63, 64, 65 and a row at n_valid = 0 with a chunk that is no multiple
# of a query block, over T = 201 cells; a window whose start falls
# mid-tile and one that leaves whole tiles below it, with softcap; and the
# 32-cell edges at D = 256
PREFILL_EDGES = {
    # name: (B, Tc, T, starts, cfg kwargs, slot_perm, n_valid)
    "edges": (6, 70, 201, [0, 1, 63, 64, 65, 0], {}, None,
              [70, 70, 70, 70, 70, 0]),
    "window_softcap": (3, 40, 256, [150, 200, 20],
                       dict(window=40, softcap=30.0), None, [40, 40, 33]),
}
PREFILL_EDGE_D256 = (3, 40, 128, [31, 32, 33], dict(H=4, KH=2, D=256), None,
                     None)


@pytest.mark.parametrize("layout", ["td", "dt"])
@pytest.mark.parametrize("kind", ["f32", "f16", "q8_0", "q4_0"])
@pytest.mark.parametrize("case", list(PREFILL_EDGES))
def test_prefill_tile_edges_match_jax(case, kind, layout):
    check_case(kind, layout, 1000 + list(PREFILL_EDGES).index(case),
               *PREFILL_EDGES[case])


def test_prefill_tile_edges_d256_match_jax():
    check_case("q4_0", "dt", 1010, *PREFILL_EDGE_D256)


@pytest.mark.parametrize("H,KH,D,ok", [(4, 2, 256, True), (32, 2, 128, True),
                                       (64, 1, 64, True), (4, 2, 258, False),
                                       (4, 2, 63, False), (6, 4, 64, False)])
def test_kernel_check_head_limits(H, KH, D, ok):
    """The CUDA wrapper takes any even head_dim up to 256 and any number of
    query heads per kv head: such shapes get past the head check and stop
    only at the device check (CPU tensors here); others are refused."""
    B, Tc, T = 1, 1, 8
    cells = torch.zeros((1, B, KH, T, D), dtype=torch.bfloat16)
    cache = TKV(cells, cells.clone(), torch.zeros((B,), dtype=torch.int32),
                None, None, kind="f16", layout="td")
    ints = torch.zeros((B,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors" if ok else
                       "unsupported heads/head_dim"):
        TFA._check(torch.zeros((B, Tc, H, D)), torch.zeros((B, KH, Tc, D)),
                   torch.zeros((B, KH, Tc, D)), cache, ints, ints, ints,
                   False, None)


# ------------------------------------------------- the decode kernels' splits
# decode_split_plain (the split arithmetic of attn_common.cuh's decode
# kernels) at a split of 16 cells, against the JAX reference: starts at the
# split edges (0, 1, C - 1, C, C + 1, T - 1), a window whose start falls
# mid-split and one that leaves whole splits below it, softcap, head_dim
# 256 and a query group past one block's chunk (DEC_MAXG = 8)
SPLIT = 16
SPLIT_T = 192
SPLIT_CASES = {
    # name: (starts, cfg kwargs)
    "edges": ([0, 1, SPLIT - 1, SPLIT, SPLIT + 1, SPLIT_T - 1], {}),
    "window": ([100, 191, 40, 17], dict(window=30)),
}
SPLIT_EXTRA = {
    # name: (kind, layout, starts, cfg kwargs)
    "softcap_f16_td": ("f16", "td", [3, 150], dict(softcap=30.0)),
    "softcap_q8_0_dt": ("q8_0", "dt", [3, 150], dict(softcap=30.0)),
    "d256_f16_td": ("f16", "td", [0, 70, 191], dict(D=256)),
    "d256_q4_0_dt": ("q4_0", "dt", [0, 70, 191], dict(D=256)),
    "g12_f16_td": ("f16", "td", [16, 90], dict(H=24, KH=2)),
    "g12_q4_0_dt": ("q4_0", "dt", [16, 90], dict(H=24, KH=2)),
}


def check_split(kind, layout, seed, starts, ckw, ga=(1, 0), rot_cache=True):
    """decode_split_plain at SPLIT against the JAX attention_reference,
    2e-5 (both f32; only the order of sums differs)."""
    cfg = mk_cfg(**ckw)
    B = len(starts)
    jargs, targs, _ = make_inputs(kind, seed, B, 1, SPLIT_T, starts, cfg,
                                  layout=layout, ga=ga)
    jr = np.asarray(j_ref(*jargs, rot_cache=rot_cache))
    q, cache, li, slots, q_pos, _, kn, vn = targs[:8]
    tables = None if rot_cache else TFA.rope_tables(cfg, SPLIT_T, *ga, "cpu")
    out = TFA.decode_split_plain(
        q, cache, li, slots, q_pos[:, 0], kn, vn, cfg.layer_window(li),
        cfg.attention_scale(), float(cfg.attn_logit_softcap), tables=tables,
        split=SPLIT).numpy()
    np.testing.assert_allclose(out, jr, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("layout", ["td", "dt"])
@pytest.mark.parametrize("kind", ["f32", "f16", "q8_0", "q4_0"])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_decode_splits_match_jax(case, kind, layout):
    check_split(kind, layout, 800 + list(SPLIT_CASES).index(case),
                *SPLIT_CASES[case])


@pytest.mark.parametrize("case", list(SPLIT_EXTRA))
def test_decode_splits_heads_softcap_match_jax(case):
    check_split(*SPLIT_EXTRA[case][:2], 820 + list(SPLIT_EXTRA).index(case),
                *SPLIT_EXTRA[case][2:])


def test_decode_split_matches_kernel_constant():
    """DEC_SPLIT, which sizes the decode workspace, is attn_common.cuh's."""
    import os
    import re

    path = os.path.join(os.path.dirname(TFA.__file__), os.pardir, "csrc",
                        "attn_common.cuh")
    with open(path) as fh:
        (c,) = re.findall(r"constexpr int DEC_SPLIT = (\d+);", fh.read())
    assert int(c) == TFA.DEC_SPLIT
    assert TFA.decode_splits(512) == 512 // int(c) + 1
