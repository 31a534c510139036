"""The port's load-time block extraction (kernels/extract.py, the CUDA
kernel's plain version here) and the loader route through it
(model/weights.extract_staged, model/loader.load_model):

  - extract_plain against the JAX package's to_device_format, bit for bit,
    for the ten LAYOUTS types on random blocks whose f16 fields take
    random bit patterns (negatives, zeros, subnormals; no Inf/NaN), at 1,
    3 and 33 rows; and, where the JAX package's native library is built,
    against its extract_device with the kernel permutation undone;
  - the staged route in small chunks (a ragged last chunk) equals one
    extract_plain call of the whole tensor;
  - load_model on the CPU (a tiny phi3 family file, a Q4_K_M-mix model)
    gives the QTensors of the route before it (numpy to_device_format of
    the whole tensor, then the upload), also under a TP=2 sharder (each
    rank's slices equal the host-sliced ones);
  - routing: on a CPU tensor extract runs extract_plain, and
    qtensor_from_gguf reaches extract for every LAYOUTS type.
"""

import numpy as np
import pytest
import torch

from tpu_engine.quant import device_format as JDF
from tpu_engine_torch.dist.sharding import make_sharder
from tpu_engine_torch.gguf.constants import GGML_BLOCK_INFO, GGMLType
from tpu_engine_torch.gguf.reader import read_gguf
from tpu_engine_torch.gguf.writer import GGUFWriter
from tpu_engine_torch.kernels import extract as EX
from tpu_engine_torch.model import loader as LD
from tpu_engine_torch.model import weights as W
from tpu_engine_torch.quant.device_format import LAYOUTS, to_device_format
from tpu_engine_torch.tools.family_gguf import Widths, build_family_gguf
from tpu_engine_torch.tools.q4km import build_q4km_gguf

torch.set_num_threads(2)

TYPES = list(LAYOUTS)
# byte offsets of each block's f16 fields (d, and dmin / m where present)
F16_AT = {GGMLType.Q4_0: (0,), GGMLType.Q4_1: (0, 2), GGMLType.Q5_0: (0,),
          GGMLType.Q5_1: (0, 2), GGMLType.Q8_0: (0,), GGMLType.Q2_K: (80, 82),
          GGMLType.Q3_K: (108,), GGMLType.Q4_K: (0, 2), GGMLType.Q5_K: (0, 2),
          GGMLType.Q6_K: (208,)}
PHI3 = Widths(2, 768, 8, 8, 96, 512, 512)  # tests/test_torch_families.py's


def random_blocks(ty, n: int, k: int, seed: int) -> np.ndarray:
    """n rows of k elements of type ty as random block bytes: every byte
    random, each f16 field a random finite bit pattern (an Inf/NaN
    exponent turned into a subnormal one), the first block's d zero."""
    rng = np.random.default_rng(seed)
    blk, nbytes = GGML_BLOCK_INFO[ty]
    nb = n * k // blk
    raw = rng.integers(0, 256, size=(nb, nbytes), dtype=np.uint8)
    for off in F16_AT[ty]:
        h = rng.integers(0, 1 << 16, size=nb).astype(np.uint16)
        h[(h & 0x7C00) == 0x7C00] &= 0x83FF
        raw[:, off:off + 2] = h.view(np.uint8).reshape(nb, 2)
    raw[0, F16_AT[ty][0]:F16_AT[ty][0] + 2] = 0
    return raw.reshape(-1)


def same_bits(a: torch.Tensor, b) -> bool:
    """Equal dtype, shape and bytes (f32 -0.0 apart from 0.0)."""
    b = torch.as_tensor(np.ascontiguousarray(b)) if isinstance(b, np.ndarray) else b
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


@pytest.mark.parametrize("n", [1, 3, 33])
@pytest.mark.parametrize("ty", TYPES, ids=lambda t: t.name)
def test_extract_plain_matches_jax_bit_for_bit(ty, n):
    blk = GGML_BLOCK_INFO[ty][0]
    k = blk * (3 if blk == 32 else 2)
    raw = random_blocks(ty, n, k, seed=int(ty) * 100 + n)
    qs, scale, bias = EX.extract(torch.from_numpy(raw.copy()), ty, n, k)
    ref = JDF.to_device_format(raw, ty, (n, k))
    assert same_bits(qs, ref.qs)
    assert same_bits(scale, ref.scale.astype(np.float32))
    if LAYOUTS[ty].has_bias:  # Q5_0 keeps its all-zero bias
        assert same_bits(bias, ref.bias.astype(np.float32))
    else:
        assert bias is None and ref.bias is None


@pytest.mark.parametrize("ty", TYPES, ids=lambda t: t.name)
def test_extract_plain_matches_jax_native(ty):
    from tpu_engine.native import lib as native

    if not native.available():
        pytest.skip("the JAX package's native library is not built")
    n, k = 33, 2 * GGML_BLOCK_INFO[ty][0]
    raw = random_blocks(ty, n, k, seed=int(ty))
    qs, scale, bias = EX.extract(torch.from_numpy(raw.copy()), ty, n, k)
    nq, nsc, nb = native.extract_device(raw, ty, n, k)
    lay = LAYOUTS[ty]
    unperm = (JDF.unpermute_group_transpose_nib4 if lay.kind == "nib4"
              else JDF.unpermute_group_transpose_i8)
    assert same_bits(qs, unperm(nq, lay.group))
    assert same_bits(scale, nsc)
    assert (bias is None) == (nb is None)
    if bias is not None:
        assert same_bits(bias, nb)


@pytest.mark.parametrize("ty", TYPES, ids=lambda t: t.name)
def test_staged_chunks_equal_one_extract(ty, monkeypatch):
    """STAGE_BYTES of about 4 rows: 33 rows go in 9 chunks, the last of 1."""
    n, k = 33, 2 * GGML_BLOCK_INFO[ty][0]
    raw = random_blocks(ty, n, k, seed=7 + int(ty))
    row_bytes = raw.size // n
    monkeypatch.setattr(W, "STAGE_BYTES", 4 * row_bytes + 1)
    calls = []
    real = EX.extract

    def spy(src, *a, **kw):
        calls.append(src.numel())
        return real(src, *a, **kw)

    monkeypatch.setattr(EX, "extract", spy)
    ro = raw.copy()
    ro.flags.writeable = False  # as the GGUF's mmap view
    split = W.LoadSplit("cpu")
    got = W.extract_staged(ro, ty, n, k, "cpu", split)
    assert calls == [4 * row_bytes] * 8 + [row_bytes]
    want = EX.extract_plain(torch.from_numpy(raw.copy()), ty, n, k)
    for a, b in zip(got, want):
        assert (a is None and b is None) or same_bits(a, b)
    assert {"stage", "upload", "extract"} <= set(split.seconds())


def test_extract_refuses_what_it_does_not_take():
    raw = torch.zeros(34 * 2, dtype=torch.uint8)
    with pytest.raises(ValueError, match="LAYOUTS"):
        EX.extract(raw, GGMLType.F16, 2, 32)
    with pytest.raises(ValueError, match="uint8"):
        EX.extract(raw[:-1], GGMLType.Q8_0, 2, 32)
    with pytest.raises(ValueError, match="block"):
        EX.extract(raw, GGMLType.Q8_0, 1, 48)
    with pytest.raises(ValueError, match="device"):
        EX.extract(raw.to("meta"), GGMLType.Q8_0, 2, 32)


def test_extract_on_cpu_runs_plain(monkeypatch):
    seen = []
    real = EX.extract_plain

    def spy(*a):
        seen.append(a[1])
        return real(*a)

    monkeypatch.setattr(EX, "extract_plain", spy)
    before = EX.LAUNCHES["extract"]
    raw = torch.from_numpy(random_blocks(GGMLType.Q4_K, 2, 256, seed=1))
    out = EX.alloc(GGMLType.Q4_K, 2, 256, "cpu")
    got = EX.extract(raw, GGMLType.Q4_K, 2, 256, out=out)
    assert seen == [GGMLType.Q4_K] and got is out
    assert EX.LAUNCHES["extract"] == before  # no kernel launched


def test_qtensor_from_gguf_reaches_extract_for_every_type(tmp_path,
                                                          monkeypatch):
    path = str(tmp_path / "types.gguf")
    w = GGUFWriter(path)
    rng = np.random.default_rng(3)
    for ty in TYPES:
        w.add_tensor(f"t.{ty.name}", rng.standard_normal((5, 256))
                     .astype(np.float32), ty)
    w.add_tensor("t.F16", rng.standard_normal((5, 64)).astype(np.float16))
    w.write()
    seen = []
    real = EX.extract

    def spy(raw, ty, *a, **kw):
        seen.append(GGMLType(ty))
        return real(raw, ty, *a, **kw)

    monkeypatch.setattr(EX, "extract", spy)
    g = read_gguf(path)
    try:
        for ty in TYPES:
            qt = W.qtensor_from_gguf(g, f"t.{ty.name}", "cpu")
            ref = to_device_format(g.tensor_bytes(f"t.{ty.name}"), ty, (5, 256))
            assert (qt.kind, qt.group) == (ref.layout.kind, ref.layout.group)
            assert same_bits(qt.qs, ref.qs) and same_bits(qt.scale, ref.scale)
        dense = W.qtensor_from_gguf(g, "t.F16", "cpu")
    finally:
        g.close()
    assert seen == TYPES and dense.kind == "dense"


def _before(g, name, device, dtype=torch.float32, split=None):
    """qtensor_from_gguf as it was: numpy to_device_format of the whole
    tensor on the host, then one upload an array."""
    ti = g.tensors[name]
    k = ti.shape[-1]
    n = ti.n_elems // k
    if ti.ggml_type not in LAYOUTS:
        return W.qtensor_from_gguf(g, name, device, dtype)
    lay = LAYOUTS[ti.ggml_type]
    dq = to_device_format(g.tensor_bytes(name), ti.ggml_type, (n, k))
    return W.QTensor(qs=W._to(dq.qs, device), scale=W._to(dq.scale, device),
                     bias=None if dq.bias is None else W._to(dq.bias, device),
                     kind=lay.kind, group=lay.group, shape=(n, k))


def _same_weights(a, b, where="") -> int:
    """Assert two weight trees equal bit for bit; returns the number of
    quantized QTensors compared."""
    if isinstance(a, W.QTensor):
        assert (a.kind, a.group, a.shape) == (b.kind, b.group, b.shape), where
        for x, y in ((a.qs, b.qs), (a.scale, b.scale), (a.bias, b.bias)):
            assert (x is None and y is None) or same_bits(x, y), where
        return a.kind != "dense"
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        return sum(_same_weights(a[k], b[k], f"{where}.{k}") for k in a)
    if isinstance(a, list):
        return sum(_same_weights(x, y, f"{where}[{i}]")
                   for i, (x, y) in enumerate(zip(a, b)))
    assert same_bits(a, b), where
    return 0


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("extract_models")
    return {"phi3": build_family_gguf(str(d / "phi3.gguf"), "phi3", n_layer=2,
                                      seed=0, widths=PHI3, threads=2),
            "q4km": build_q4km_gguf(str(d / "q4km.gguf"), "tiny", n_layer=4)}


def _load(path, monkeypatch, old: bool, sharder=None):
    with monkeypatch.context() as m:
        if old:
            m.setattr(LD, "qtensor_from_gguf", _before)
        else:  # chunks of a few rows: the staged route's edges
            m.setattr(W, "STAGE_BYTES", 3000)
        return LD.load_model(path, device="cpu", sharder=sharder)


@pytest.mark.parametrize("model", ["phi3", "q4km"])
def test_load_model_same_qtensors_as_before(models, model, monkeypatch):
    new = _load(models[model], monkeypatch, old=False)
    old = _load(models[model], monkeypatch, old=True)
    n_quant = _same_weights(new.weights, old.weights)
    assert n_quant >= 2 * 4 + 1
    split = new.load_split
    assert {"read", "tokenizer", "stage", "upload", "extract", "norms",
            "permute_fuse", "total"} <= set(split)
    assert all(v >= 0 for v in split.values())


@pytest.mark.parametrize("model", ["phi3", "q4km"])
def test_tp2_rank_slices_same_as_host_sliced(models, model, monkeypatch):
    whole = _load(models[model], monkeypatch, old=False).weights
    for r in range(2):
        new = _load(models[model], monkeypatch, old=False,
                    sharder=make_sharder(2, r)).weights
        old = _load(models[model], monkeypatch, old=True,
                    sharder=make_sharder(2, r)).weights
        assert _same_weights(new, old, f"rank {r}") > 0
        # the rank holds slices, not the whole model
        assert new["layers"][0]["wo"].shape[1] == whole["layers"][0]["wo"].shape[1] // 2
