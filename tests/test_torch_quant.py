"""Quantized weights in the port (tpu_engine_torch.model.weights and
kernels.dequant_matmul) against the JAX package.

  - dequant is bit-exact against tpu_engine.model.weights.dequant for every
    type in LAYOUTS: through the port's own GGUF loader (the JAX side with
    TPU_ENGINE_BF16_SCALES=0, i.e. f32 scale storage like the port's), and
    through from_jax_params at the JAX defaults (bf16 scales, group
    transposition, k_pad), which widens and un-permutes exactly;
  - qmatmul_plain against the JAX XLA qmatmul: both are f32 dequant + f32
    matmul, so only the summation order differs: 1e-5 of max |y|;
  - qmatmul_plain against pallas_qmatmul in interpret mode for Q4_K and
    Q6_K at M in {1, 8, 16}: the TPU kernel rounds x and q*scale to bf16
    before its dot (2^-9 relative each), so 1e-2 of max |y|;
  - qmm_nib4_plain and qmm_i8_plain, the plain twins of the CUDA kernels
    qmm_nib4 and qmm_i8, which round as the TPU kernels do, against
    pallas_qmatmul in interpret mode for every nib4 type (Q4_K, Q4_0,
    Q4_1, Q2_K) and every i8 type (Q6_K, Q8_0, Q5_0, Q5_1, Q5_K, Q3_K) at
    M in {1, 8, 16}: only the order of f32 sums and the TPU kernel's
    bf16x3 bias product (exact to ~2^-17 of each term) differ, so 1e-4 of
    max |y|.
K = 3840 makes the JAX loader lane-pad every group cycle (ng = 120 or 240
-> k_pad), so the k_pad path is exercised.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.gguf.constants import GGMLType
from tpu_engine.gguf.reader import read_gguf as j_read
from tpu_engine.gguf.writer import GGUFWriter
from tpu_engine.kernels import dequant_matmul as JDM
from tpu_engine.model import weights as JW
from tpu_engine.quant.device_format import LAYOUTS
from tpu_engine_torch.gguf.reader import read_gguf as t_read
from tpu_engine_torch.kernels import dequant_matmul as TDM
from tpu_engine_torch.model import weights as TW

torch.set_num_threads(2)

TYPES = sorted(LAYOUTS, key=int)
N, K = 8, 3840          # k_pad shape (dequant tests)
NK, KK = 128, 512       # kernel-tileable shape (pallas interpret tests)
NIB4_TYPES = (GGMLType.Q4_K, GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q2_K)
I8_TYPES = (GGMLType.Q6_K, GGMLType.Q8_0, GGMLType.Q5_0, GGMLType.Q5_1,
            GGMLType.Q5_K, GGMLType.Q3_K)
KERNEL_TYPES = NIB4_TYPES + I8_TYPES


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("q") / "types.gguf")
    rng = np.random.default_rng(21)
    w = GGUFWriter(path)
    w.add("general.architecture", "llama")
    for ty in TYPES:
        w.add_tensor(f"w.{ty.name}", rng.standard_normal((N, K)).astype(
            np.float32) * 0.05, ty)
    for ty in KERNEL_TYPES:
        w.add_tensor(f"k.{ty.name}", rng.standard_normal((NK, KK)).astype(
            np.float32) * 0.05, ty)
    w.write()
    return path


def jax_qt(path, name, monkeypatch=None, bf16=True):
    if monkeypatch is not None:
        monkeypatch.setenv("TPU_ENGINE_BF16_SCALES", "1" if bf16 else "0")
    g = j_read(path)
    try:
        return JW.qtensor_from_gguf(g, name)
    finally:
        g.close()


def port_qt(path, name):
    g = t_read(path)
    try:
        return TW.qtensor_from_gguf(g, name, "cpu")
    finally:
        g.close()


def as_mapping(qt) -> dict:
    return dict(qs=np.asarray(qt.qs), kind=qt.kind, group=qt.group,
                scale=None if qt.scale is None else np.asarray(qt.scale),
                bias=None if qt.bias is None else np.asarray(qt.bias),
                shape=qt.shape, perm=qt.perm, perm_shards=qt.perm_shards,
                packed=qt.packed, k_pad=qt.k_pad)


def carried(jqt) -> TW.QTensor:
    params = {"token_embd": as_mapping(jqt), "output_norm": np.ones(4),
              "layers": []}
    return TW.from_jax_params(params, types.SimpleNamespace(n_layer=0),
                              "cpu")["token_embd"]


@pytest.mark.parametrize("ty", TYPES, ids=lambda t: t.name)
def test_dequant_bit_exact_via_gguf(gguf, monkeypatch, ty):
    jqt = jax_qt(gguf, f"w.{ty.name}", monkeypatch, bf16=False)
    tqt = port_qt(gguf, f"w.{ty.name}")
    assert tqt.kind == LAYOUTS[ty].kind and tqt.group == LAYOUTS[ty].group
    ref = np.asarray(JW.dequant(jqt))
    got = TW.dequant(tqt).numpy()
    assert got.shape == (N, K)
    np.testing.assert_array_equal(got, ref)
    # embedding rows too
    ids = np.asarray([3, 0, 7], np.int32)
    np.testing.assert_array_equal(
        TW.embed_rows(tqt, torch.from_numpy(ids)).numpy(),
        np.asarray(JW.embed_rows(jqt, jnp.asarray(ids))))


@pytest.mark.parametrize("ty", TYPES, ids=lambda t: t.name)
def test_dequant_bit_exact_via_from_jax_params(gguf, ty):
    jqt = jax_qt(gguf, f"w.{ty.name}")  # JAX defaults: bf16 scales, k_pad
    tqt = carried(jqt)
    np.testing.assert_array_equal(TW.dequant(tqt).numpy(),
                                  np.asarray(JW.dequant(jqt)))


@pytest.mark.parametrize("ty", TYPES, ids=lambda t: t.name)
def test_qmatmul_plain_matches_xla(gguf, ty):
    jqt = jax_qt(gguf, f"w.{ty.name}")
    tqt = carried(jqt)
    x = np.random.default_rng(int(ty)).standard_normal((5, K)).astype(np.float32)
    assert JW.get_pallas_qmatmul() is None
    ref = np.asarray(JW.qmatmul(jnp.asarray(x), jqt))
    got = TDM.qmatmul(torch.from_numpy(x), tqt).numpy()  # CPU -> plain
    np.testing.assert_array_equal(got, TDM.qmatmul_plain(
        torch.from_numpy(x), tqt).numpy())
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


PALLAS_CASES = [  # (type, port function, tolerance of max |y|)
    (GGMLType.Q4_K, TDM.qmatmul_plain, 1e-2),
    (GGMLType.Q6_K, TDM.qmatmul_plain, 1e-2),
    *((ty, TDM.qmm_nib4_plain, 1e-4) for ty in NIB4_TYPES),
    *((ty, TDM.qmm_i8_plain, 1e-4) for ty in I8_TYPES),
]


@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize(
    "ty,fn,tol", PALLAS_CASES,
    ids=[ty.name + ("" if fn is TDM.qmatmul_plain else "-twin")
         for ty, fn, _ in PALLAS_CASES])
def test_qmatmul_plain_matches_pallas_interpret(gguf, ty, fn, tol, m):
    jqt = jax_qt(gguf, f"k.{ty.name}")
    tqt = carried(jqt)
    x = np.random.default_rng(m).standard_normal((m, KK)).astype(np.float32)
    JDM.enable(interpret=True)
    try:
        ref = np.asarray(JW.qmatmul(jnp.asarray(x), jqt))
    finally:
        JDM.disable()
        JDM._INTERPRET = False
    got = fn(torch.from_numpy(x), tqt).numpy()
    assert got.shape == (m, NK)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("ty", [GGMLType.Q4_K, GGMLType.Q2_K, GGMLType.Q6_K,
                                GGMLType.Q5_K], ids=lambda t: t.name)
def test_qmatmul_twin_routes_to_each_kernels_twin(gguf, ty):
    """qmatmul_twin gives nib4 weights qmm_nib4_plain and i8 weights
    qmm_i8_plain, bit for bit (bf16 roundings: not qmatmul_plain's f32
    product, but within 1e-2 of it); qmatmul on a CPU tensor stays
    qmatmul_plain."""
    tqt = carried(jax_qt(gguf, f"k.{ty.name}"))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, KK)).astype(np.float32))
    twin = TDM.qmatmul_twin(x, tqt)
    plain = TDM.qmatmul_plain(x, tqt)
    torch.testing.assert_close(TDM.qmatmul(x, tqt), plain, rtol=0, atol=0)
    kernel_twin = (TDM.qmm_nib4_plain if tqt.kind == "nib4"
                   else TDM.qmm_i8_plain)
    torch.testing.assert_close(twin, kernel_twin(x, tqt), rtol=0, atol=0)
    assert not torch.equal(twin, plain)
    torch.testing.assert_close(twin, plain, rtol=0,
                               atol=1e-2 * float(plain.abs().max()))


def test_from_jax_params_refuses_packed_scales(gguf):
    m = as_mapping(jax_qt(gguf, f"w.{GGMLType.Q4_K.name}"))
    m["packed"] = True
    with pytest.raises(ValueError, match="packed"):
        TW.from_jax_params({"token_embd": m, "layers": []},
                           types.SimpleNamespace(n_layer=0), "cpu")


@pytest.mark.parametrize("kind", ["nib4", "i8"])
def test_cuda_wrapper_checks_before_launch(kind):
    """The CUDA wrapper raises on what the kernel does not take (here: CPU
    tensors) before touching the kernel library."""
    x = torch.zeros((2, 64))
    qs = (torch.zeros((4, 32), dtype=torch.uint8) if kind == "nib4"
          else torch.zeros((4, 64), dtype=torch.int8))
    qt = TW.QTensor(qs=qs, scale=torch.ones((4, 2)), bias=None, kind=kind,
                    group=32, shape=(4, 64))
    with pytest.raises(ValueError, match="CUDA"):
        TDM.qmm_cuda(x, qt)
