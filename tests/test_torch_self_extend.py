"""The port's attention with K stored unrotated (rot_cache=False: the
self-extend path, grp_attn_n > 1) against the JAX package's
attention_reference and its Pallas flash_attention in interpret mode, for
every path the JAX package routes unrotated K to:
  - "td" cache, f32/f16 (bf16 cells), q8_0 and q4_0: _decode_kernel (B8,
    Tc = 1) and _prefill_kernel (B4, rotated=False);
  - "dt" cache, all four kinds: _decode_kernel_t (B6, rotated=False; the
    JAX package never sends unrotated K to _decode_kernel_dma) and
    _prefill_kernel_t (B7, rotated=False).
Cases mirror tests/test_flash_attention.py test_self_extend and
test_dt_self_extend (ga_n=4, ga_w=32, so fills cross the window and both
remapped and plain cells are read) over test_torch_attention.py's cases,
plus rope_dim = D/2 (the unrotated tail passes through) and ga_n = 1 (the
identity map). Also: on CUDA tensors flash_attention asks for the rope
kernel of the cache's layout and Tc, with tables built once per cache,
equal to rope_cos_sin(self_extend_pos(arange(T))) and to the JAX
package's.

Tolerance 2e-5 throughout: both references and the four TPU kernels
rotate and multiply in f32 (_decode_kernel casts q and K to f32,
_decode_kernel_t computes in f32 when rotated=False), and the two
frameworks' cos/sin of the same f32 angles differ by an ulp at most.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_attention import (CASES, DT_CASES, PREFILL_EDGE_D256,
                                        PREFILL_EDGES, SPLIT_CASES,
                                        SPLIT_EXTRA, check_split, mk_cfg,
                                        run_case)
from tpu_engine.kernels import flash_attention as JFA
from tpu_engine_torch.kernels import flash_attention as TFA
from tpu_engine_torch.kvcache.cache import KVCache as TKV
from tpu_engine_torch.model.llama import rope_cos_sin, self_extend_pos

torch.set_num_threads(2)

GA = (4, 32)
TOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_mode():
    JFA._INTERPRET = True
    yield
    JFA._INTERPRET = False


def check(kind, layout, seed, B, Tc, T, starts, ckw, perm=None, nv_in=None,
          ga=GA, rope_dim=None):
    cfg = mk_cfg(**ckw, rope_dim=rope_dim)
    jr, jp, tr, tf, nv = run_case(kind, seed, B, Tc, T, starts, cfg, perm,
                                  nv_in, layout=layout, ga=ga,
                                  rot_cache=False)
    # rows past n_valid are padding in both packages: compare valid rows
    valid = np.arange(Tc)[None, :] < nv[:, None]
    np.testing.assert_allclose(tr[valid], jr[valid], rtol=TOL, atol=TOL)
    # the port's flash_attention on CPU tensors IS the plain version
    np.testing.assert_array_equal(tf, tr)
    np.testing.assert_allclose(tr[valid], jp[valid], rtol=TOL, atol=TOL)


TD_CASES = ("decode", "prefill", "continuation", "mixed_lengths", "gqa",
            "window_decode", "ragged_n_valid")
KINDS = ["f32", "f16", "q8_0", "q4_0"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", TD_CASES)
def test_td_self_extend_matches_jax(case, kind):
    """B8 (decode) and B4 rotated=False (prefill) on the "td" cache."""
    check(kind, "td", 400 + TD_CASES.index(case), *CASES[case])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", list(DT_CASES))
def test_dt_self_extend_matches_jax(case, kind):
    """B6 rotated=False (decode, t_decode and dma_decode alike) and B7
    rotated=False (prefill) on the "dt" cache."""
    check(kind, "dt", 500 + list(DT_CASES).index(case), *DT_CASES[case])


@pytest.mark.parametrize("kind", ["f32", "q4_0"])
@pytest.mark.parametrize("layout", ["td", "dt"])
@pytest.mark.parametrize("case", ["decode", "continuation"])
def test_partial_rope_dim_matches_jax(case, layout, kind):
    """rope_dim = D/2: elements d >= rope_dim pass through unrotated, and a
    q4_0 pair's partner sits in another byte than its own."""
    check(kind, layout, 600, *CASES[case], rope_dim=32)


@pytest.mark.parametrize("layout", ["td", "dt"])
@pytest.mark.parametrize("case", ["decode", "continuation"])
def test_ga_n_1_matches_jax(case, layout):
    """ga_n = 1: unrotated K rotated by its plain cell index."""
    check("f16", layout, 700, *CASES[case], ga=(1, 0))


@pytest.mark.parametrize("layout", ["td", "dt"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", list(PREFILL_EDGES))
def test_prefill_tile_edges_self_extend_match_jax(case, kind, layout):
    """The prefill kernels' tile edges (test_torch_attention.py) with K
    stored unrotated: B4 and B7 rotated=False."""
    check(kind, layout, 1100 + list(PREFILL_EDGES).index(case),
          *PREFILL_EDGES[case])


def test_prefill_tile_edges_d256_self_extend_match_jax():
    check("f16", "td", 1110, *PREFILL_EDGE_D256)


# decode_split_plain with K stored unrotated: the split cases of
# test_torch_attention.py at ga_n 4, ga_w 128 (cells past 128 remapped)
SPLIT_GA = (4, 128)


@pytest.mark.parametrize("layout", ["td", "dt"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_decode_splits_self_extend_match_jax(case, kind, layout):
    check_split(kind, layout, 900 + list(SPLIT_CASES).index(case),
                *SPLIT_CASES[case], ga=SPLIT_GA, rot_cache=False)


@pytest.mark.parametrize("case", list(SPLIT_EXTRA))
def test_decode_splits_self_extend_heads_softcap_match_jax(case):
    check_split(*SPLIT_EXTRA[case][:2], 920 + list(SPLIT_EXTRA).index(case),
                *SPLIT_EXTRA[case][2:], ga=SPLIT_GA, rot_cache=False)


# ----------------------------------------------------------------- routing
def _meta_cache(layout, cfg, T=96, B=2):
    """An f16 cache of "meta" tensors (a device other than the CPU, so
    flash_attention takes the kernel route; nothing is computed)."""
    KH, D = cfg.n_kv_head, cfg.head_dim
    m = dict(device="meta")
    shape = (1, B, KH, D, T) if layout == "dt" else (1, B, KH, T, D)
    return TKV(torch.empty(shape, dtype=torch.bfloat16, **m),
               torch.empty(shape, dtype=torch.bfloat16, **m),
               torch.empty((B,), dtype=torch.int32, **m), kind="f16",
               layout=layout)


def _meta_call(layout, Tc, li=0, ga=GA, rot_cache=False, cfg=None,
               cache=None):
    """flash_attention on "meta" tensors, on `cache` or a new one."""
    cfg = cfg or mk_cfg()
    cache = cache or _meta_cache(layout, cfg)
    B, T = cache.n_slots, cache.max_len
    H, KH, D = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    m = dict(device="meta")
    q = torch.empty((B, Tc, H, D), **m)
    kn, vn = (torch.empty((B, KH, Tc, D), **m) for _ in range(2))
    ints = torch.empty((B, Tc), dtype=torch.int32, **m)
    return TFA.flash_attention(q, cache, li, ints[:, 0], ints, ints[:, 0], kn,
                               vn, cfg, *ga, rot_cache=rot_cache)


@pytest.mark.parametrize("Tc", [1, 8])
@pytest.mark.parametrize("layout", ["td", "dt"])
def test_cuda_path_routes_unrotated_k_to_rope_kernels(monkeypatch, layout, Tc):
    """Off the CPU, rot_cache=False launches the rope kernel of the cache's
    layout and Tc (never attention_reference), with the tables built once
    per cache across layers and steps and kept on it; rot_cache=True
    launches the rotated kernel with no tables."""
    calls, builds = [], []
    real_cos_sin = TFA.rope_cos_sin

    def counting_cos_sin(pos, cfg):
        builds.append(tuple(pos.shape))
        return real_cos_sin(pos, cfg)

    def fake_kernel(name, q, *args, tables=None):
        calls.append((name, tables))
        return torch.empty_like(q)

    def no_plain(*a, **kw):
        raise AssertionError("attention_reference ran on a non-CPU tensor")

    monkeypatch.setattr(TFA, "rope_cos_sin", counting_cos_sin)
    monkeypatch.setattr(TFA, "attn_kernel", fake_kernel)
    monkeypatch.setattr(TFA, "attention_reference", no_plain)
    cfg = mk_cfg()
    cache = _meta_cache(layout, cfg)
    for li in (0, 1, 0):
        _meta_call(layout, Tc, li=li, cfg=cfg, cache=cache)
    want = ("attn_decode" if Tc == 1 else "attn_prefill") + (
        "_dt" if layout == "dt" else "") + "_rope"
    assert [n for n, _ in calls] == [want] * 3
    assert builds == [(96,)]
    cos, sin = calls[0][1]
    assert cos.shape == sin.shape == (96, cfg.rope_dim // 2)
    assert cos.device.type == "meta"
    assert all(t[0] is cos and t[1] is sin for _, t in calls)
    (kept,) = cache.rope_tables.values()
    assert kept[0] is cos and kept[1] is sin
    # another window is another table; another cache (another loaded
    # model) builds its own; the rotated path takes none
    _meta_call(layout, Tc, ga=(4, 16), cfg=cfg, cache=cache)
    assert len(builds) == 2 and calls[-1][1][0] is not cos
    _meta_call(layout, Tc, cfg=cfg)
    assert len(builds) == 3 and calls[-1][1][0] is not cos
    _meta_call(layout, Tc, rot_cache=True, cfg=cfg, cache=cache)
    assert calls[-1] == (want[: -len("_rope")], None)


@pytest.mark.parametrize("ga", [(4, 32), (3, 7), (1, 0)])
def test_rope_tables_match_reference_and_jax(ga):
    """The tables the rope kernels read are the plain version's cos/sin of
    each cell (bit for bit) and the JAX package's _rope_tables."""
    cfg, T = mk_cfg(), 200
    cos, sin = TFA.rope_tables(cfg, T, *ga, "cpu")
    assert cos.dtype == torch.float32 and cos.is_contiguous()
    pos = self_extend_pos(torch.arange(T, dtype=torch.int32), *ga)
    rc, rs = rope_cos_sin(pos, cfg)
    torch.testing.assert_close(cos, rc, rtol=0, atol=0)
    torch.testing.assert_close(sin, rs, rtol=0, atol=0)
    jc, js = JFA._rope_tables(T, cfg, jnp.int32(ga[0]), jnp.int32(ga[1]))
    np.testing.assert_allclose(cos.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(js), rtol=0, atol=1e-6)


@pytest.mark.parametrize("bad", ["norm", "odd", "wide"])
def test_rope_kernels_refuse_other_rope(bad):
    """The kernels rotate split halves of an even rope_dim <= head_dim:
    anything else raises before a launch."""
    import dataclasses

    cfg = mk_cfg()
    cfg = dataclasses.replace(
        cfg, extra={}, **{"norm": dict(rope_type="norm"),
                          "odd": dict(rope_dim=31),
                          "wide": dict(rope_dim=80)}[bad])
    with pytest.raises(ValueError, match="rope"):
        _meta_call("td", 1, cfg=cfg)
