"""The port's KV cache (tpu_engine_torch.kvcache.cache) against the JAX
package's, op for op: the same rows (numpy seed) go through append_step
(prefill windows with ragged n_valid, the end-of-slot clamp, decode rows,
inactive rows), trim, seq_cp, clear_slot, clear_all and shift_compact with
and without re-rope, for the four kinds (f32, f16 as bf16 cells, q8_0,
q4_0) in both layouts ("td" [L, S, KH, T, Dk], "dt" [L, S, KH, Dk, T]).
Every cell plane, scale plane and the lengths must be byte-identical after
every op (the ops are copies, casts and the same absmax quantization),
except the K cells the re-rope rotates: see test_shift_compact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.kvcache import cache as J
from tpu_engine.model.config import ModelConfig
from tpu_engine_torch.kvcache import cache as T

torch.set_num_threads(2)

L, S, KH, TMAX, D = 2, 3, 2, 32, 16
KINDS = ("f32", "f16", "q8_0", "q4_0")


def _np(a):
    """A plane as numpy, bf16 viewed as its bit pattern."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def jplanes(jc):
    return [jc.k, jc.v] + ([jc.k_scale, jc.v_scale] if jc.quantized else [])


def tplanes(tc):
    return [tc.k, tc.v] + ([tc.k_scale, tc.v_scale] if tc.quantized else [])


def planes_equal(jc, tc, k_fma=False):
    assert (tc.kind, tc.layout, tc.quantized) == (jc.kind, jc.layout,
                                                  jc.quantized)
    for i, (ja, ta) in enumerate(zip(jplanes(jc), tplanes(tc), strict=True)):
        a, b = _np(ja), _np(ta)
        assert a.dtype == b.dtype and a.shape == b.shape
        if k_fma and i == 0:  # one rounding of a product <= max |cell|
            np.testing.assert_allclose(
                a, b, rtol=0, atol=np.finfo(np.float32).eps * np.abs(a).max())
        else:
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(jc.lengths), tc.lengths.numpy())


def append_both(jc, tc, rng, slots, starts, n_valid, active, Tc):
    B = len(slots)
    k = rng.standard_normal((L, B, KH, Tc, D)).astype(np.float32)
    v = rng.standard_normal((L, B, KH, Tc, D)).astype(np.float32)
    args = [np.asarray(a, dt) for a, dt in ((slots, np.int32), (starts, np.int32),
                                            (n_valid, np.int32), (active, bool))]
    jc = J.append_step(jc, jnp.asarray(k), jnp.asarray(v),
                       *(jnp.asarray(a) for a in args))
    T.append_step(tc, torch.from_numpy(k), torch.from_numpy(v),
                  *(torch.from_numpy(a) for a in args))
    # the forward step owns the lengths: advance them the same way in both
    lengths = np.asarray(jc.lengths).copy()
    for s, st, n, a in zip(*args):
        if a:
            lengths[s] = st + n
    jc = J.KVCache(jc.k, jc.v, jnp.asarray(lengths), jc.k_scale, jc.v_scale,
                   jc.kind, jc.layout)
    # a buffer of its own: jnp.asarray may alias `lengths`, and the port's
    # ops update tc.lengths in place while JAX's async dispatch may not
    # have read it yet
    tc.lengths = torch.from_numpy(lengths.copy())
    return jc, tc


@pytest.fixture(params=[(k, lay) for lay in ("td", "dt") for k in KINDS],
                ids=lambda p: f"{p[0]}-{p[1]}")
def caches(request):
    kind, layout = request.param
    jc = J.new_cache(L, S, TMAX, KH, D, kind=kind, layout=layout)
    tc = T.new_cache(L, S, TMAX, KH, D, kind=kind, layout=layout, device="cpu")
    return jc, tc


def filled(caches):
    """A prefill window for slots 0 and 2 (ragged n_valid, slot 1 inactive),
    then two decode steps for every slot (slot 1 inactive in the first)."""
    jc, tc = caches
    rng = np.random.default_rng(4)
    jc, tc = append_both(jc, tc, rng, [0, 1, 2], [0, 0, 0], [12, 5, 7],
                         [True, False, True], Tc=16)
    planes_equal(jc, tc)
    jc, tc = append_both(jc, tc, rng, [0, 1, 2], [12, 0, 7], [1, 1, 1],
                         [True, False, True], Tc=1)
    jc, tc = append_both(jc, tc, rng, [2, 0, 1], [8, 13, 0], [1, 1, 1],
                         [True, True, True], Tc=1)
    planes_equal(jc, tc)
    return jc, tc


def test_new_cache_matches(caches):
    jc, tc = caches
    want = {"f32": torch.float32, "f16": torch.bfloat16, "q8_0": torch.int8,
            "q4_0": torch.uint8}[jc.kind]
    assert tc.k.dtype == want
    assert tuple(tc.k.shape) == tuple(jc.k.shape)
    assert tc.max_len == jc.max_len == TMAX
    planes_equal(jc, tc)


def test_append_prefill_and_decode(caches):
    filled(caches)


def test_append_clamps_at_slot_end(caches):
    """A window crossing the slot end starts at T - Tc and rolls right."""
    jc, tc = filled(caches)
    rng = np.random.default_rng(5)
    jc, tc = append_both(jc, tc, rng, [1, 0], [TMAX - 10, 0], [6, 0],
                         [True, True], Tc=16)
    planes_equal(jc, tc)


def test_trim_seq_cp_clear_slot_clear_all(caches):
    jc, tc = filled(caches)
    jc = J.trim(jc, jnp.int32(0), jnp.int32(4))
    T.trim(tc, 0, 4)
    planes_equal(jc, tc)
    jc = J.trim(jc, jnp.int32(2), jnp.int32(30))  # no-op: longer than fill
    T.trim(tc, 2, 30)
    planes_equal(jc, tc)
    jc = J.seq_cp(jc, jnp.int32(2), jnp.int32(1))
    T.seq_cp(tc, 2, 1)
    planes_equal(jc, tc)
    jc = J.clear_slot(jc, jnp.int32(2))
    T.clear_slot(tc, 2)
    planes_equal(jc, tc)
    jc = J.clear_all(jc)
    T.clear_all(tc)
    planes_equal(jc, tc)


N_KEEP, N_DISCARD = 2, 5


@pytest.mark.parametrize("rope", [False, True])
def test_shift_compact(caches, rope):
    jc, tc = filled(caches)
    cfg = ModelConfig(
        arch="llama", n_layer=L, n_embd=KH * D, n_head=KH, n_kv_head=KH,
        head_dim=D, n_ff=16, n_vocab=32, rms_eps=1e-5, rope_dim=D,
        rope_type="neox", rope_theta=10000.0, n_ctx_train=2048)
    rp = (cfg.rope_dim, cfg.rope_freq_table()[0]) if rope else None
    jc = J.shift_compact(jc, jnp.int32(0), jnp.int32(N_KEEP),
                         jnp.int32(N_DISCARD), rope=rp)
    T.shift_compact(tc, 0, N_KEEP, N_DISCARD, rope=rp)
    assert int(tc.lengths[0]) == 14 - N_DISCARD
    # XLA:CPU contracts the f32 rotation x1*cos - x2*sin into an FMA (one
    # rounding where PyTorch rounds twice), so re-roped f32 K cells may
    # differ by the rounding of one product; bf16 cells (the serving kind)
    # and every other cell stay byte-identical
    if not (rope and jc.kind in J.KV_KINDS[2:]):
        f32_rope = rope and jc.kind == "f32"
        planes_equal(jc, tc, k_fma=f32_rope)
        if f32_rope:  # the unmoved head cells [0, n_keep] are untouched
            cells = slice(0, N_KEEP + 1)
            jk = np.asarray(jc.k)[:, 0]
            tk = tc.k[:, 0].numpy()
            if jc.layout == "dt":
                jk, tk = np.swapaxes(jk, -1, -2), np.swapaxes(tk, -1, -2)
            np.testing.assert_array_equal(jk[:, :, cells], tk[:, :, cells])
        return
    # quantized K re-roped: dequantize, rotate, requantize. V, the lengths,
    # the other slots and the unmoved cells [0, n_keep] with their scales
    # are byte-identical; a moved cell may land one quantization step
    # away (the FMA above can move a value across a rounding boundary)
    for a, b in ((jc.v, tc.v), (jc.v_scale, tc.v_scale)):
        np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_array_equal(np.asarray(jc.lengths), tc.lengths.numpy())
    for a, b in ((jc.k, tc.k), (jc.k_scale, tc.k_scale)):
        np.testing.assert_array_equal(_np(a)[:, 1:], _np(b)[:, 1:])

    def dq(cache, kc, ksc):
        kc = np.asarray(kc)[:, 0]
        if cache.layout == "dt":
            kc = np.swapaxes(kc, -1, -2)  # [L, KH, T, Dk]
        ks = np.asarray(ksc)[:, 0]
        return np.asarray(J.dequant_kv(jnp.asarray(kc), jnp.asarray(ks),
                                       cache.kind)), ks

    jd, jks = dq(jc, jc.k, jc.k_scale)
    td, tks = dq(jc, tc.k.numpy(), tc.k_scale.numpy())
    head = slice(0, N_KEEP + 1)
    np.testing.assert_array_equal(jks[..., head], tks[..., head])
    np.testing.assert_array_equal(jd[:, :, head], td[:, :, head])
    np.testing.assert_allclose(tks, jks, rtol=1e-6, atol=0)
    step = np.maximum(jks, tks)[..., None] * (1 + 1e-6)
    assert np.all(np.abs(jd - td) <= step)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("head_dim", [64, 128])
def test_default_layout_matches_jax(kind, head_dim, monkeypatch):
    monkeypatch.delenv("TPU_ENGINE_KV_LAYOUT", raising=False)
    assert T.default_layout(kind, head_dim) == J.default_layout(kind, head_dim)


@pytest.mark.parametrize("kind", ["q8_0", "q4_0"])
def test_quantize_dequant_rows_match_jax(kind):
    x = np.random.default_rng(9).standard_normal((3, 5, D)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row: scale 0, cells at the zero point
    jc, js = J.quantize_kv_rows(jnp.asarray(x), kind)
    tc, ts = T.quantize_kv_rows(torch.from_numpy(x), kind)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(
        np.asarray(J.dequant_kv(jc, js, kind)),
        T.dequant_kv(tc, ts, kind).numpy())
