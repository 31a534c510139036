"""A/B of the qmm kernels on the card.

    python -m tpu_engine_torch.tools.qmm_ab               # needs one CUDA card
    python -m tpu_engine_torch.tools.qmm_ab --against DIR
    python -m tpu_engine_torch.tools.qmm_ab --layouts

Without options: builds csrc/qmm.cu once as shipped and once per variant
below, each with tile configurations (the ``using ...Cfg = Cfg<...>;``
lines) replaced. With --against DIR: builds csrc/qmm.cu as shipped and
DIR/qmm.cu (the csrc/ of another checkout, e.g. the parent commit
unpacked with git archive); a qmm.cu whose qmm_i8 still takes f32 x and
no group sums (the f32 CUDA-core kernel) is called through that
interface and held to qmatmul_plain, the f32 function it computes.
All builds run in parallel. Times qmm_nib4 on the four Q4_K tensors and
qmm_i8 on the two Q6_K tensors of a Llama-2-7B layer (Q4_K_M: the head
and a use_more_bits layer's w_down) through qmm_cuda (the bf16 cast and
group sums included, the same in every build) at M = 8, 32 and 512, the
builds in turns and the order reversed on a second pass, each time the
median of 20 launches (tools/timing.py: device time after a 256 MB L2
flush), and holds every output against its kernel's plain twin at 1e-4
of max |y|. Prints one line per pass and shape, and the sum over each
kernel's tensors per build and M. With --layouts: the shipped build
alone, both kernels at every weight layout (group 16 or 32, with a bias
or without) on w_gateup's shape (22016x4096), to show what a bias and
the group size cost each kernel at the same shape.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys

import torch

from ..kernels import _build
from ..kernels import dequant_matmul as DM
from ..model.weights import QTensor
from .timing import Timer

# variant -> {config name: its Cfg<...> template arguments}
VARIANTS = {
    "shipped": {},
    # qmm_i8 at decode: nib4's tile (1024-wide chunks, two stages); 512-wide
    # chunks in two stages, two blocks an SM; 16 weight rows (x padded to
    # 16), two blocks an SM
    "i8_dec_kc1024": {"DecCfgI8": "I8, 32, 8, 32, 8, 8, 1024, 2, 32, 8, 1"},
    "i8_dec_minb2": {"DecCfgI8": "I8, 32, 8, 32, 8, 8, 512, 2, 32, 8, 2"},
    "i8_dec_bn16": {"DecCfgI8": "I8, 16, 16, 16, 16, 8, 512, 3, 16, 16, 2"},
    # M 9..64: three stages, one block an SM; M > 64: 64-wide chunks,
    # three stages
    "i8_mid_nst3": {"MidCfgI8": "I8, 32, 32, 32, 32, 4, 256, 3, 16, 16, 1"},
    "i8_pre_kc64": {"PreCfgI8": "I8, 128, 128, 64, 32, 1, 64, 3, 16, 16, 1"},
}
SHAPES = [  # (tensor, kind, group, has_bias, N, K)
    ("wqkv Q4_K", "nib4", 32, True, 12288, 4096),
    ("wo Q4_K", "nib4", 32, True, 4096, 4096),
    ("w_gateup Q4_K", "nib4", 32, True, 22016, 4096),
    ("w_down Q4_K", "nib4", 32, True, 4096, 11008),
    ("output Q6_K", "i8", 16, False, 32000, 4096),
    ("w_down Q6_K", "i8", 16, False, 4096, 11008),
]
LAYOUT_SHAPES = [  # every layout of quant/device_format.py on one shape
    (f"w_gateup {name}", kind, group, has_bias, 22016, 4096)
    for name, kind, group, has_bias in (
        ("Q4_K", "nib4", 32, True), ("nib4 no bias", "nib4", 32, False),
        ("Q2_K", "nib4", 16, True), ("Q6_K", "i8", 16, False),
        ("Q8_0", "i8", 32, False), ("Q5_K", "i8", 32, True))]
# the C interface of qmm_i8 before it took bf16 x and its group sums
F32_I8 = "qmm_i8(const void* x, const void* qs,"


def build(texts: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """texts: build name -> qmm.cu source; nvcc for each, in parallel."""
    procs = {}
    for name, text in texts.items():
        d = os.path.join(_build.BUILD_ROOT, "qmm_ab", name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        with open(os.path.join(d, "qmm.cu"), "w") as fh:
            fh.write(text)
        procs[name] = (d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(d, "qmm.so"),
             os.path.join(d, "qmm.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (d, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {name}:\n{log.decode(errors='replace')}")
        regs = [ln.split("Used ")[1].split(",")[0]
                for ln in log.decode().splitlines() if "Used " in ln]
        print(f"{name}: registers {regs}", flush=True)
        libs[name] = ctypes.CDLL(os.path.join(d, "qmm.so"))
    return libs


def variant_texts() -> dict[str, str]:
    src = open(os.path.join(_build.CSRC, "qmm.cu")).read()
    texts = {}
    for name, repl in VARIANTS.items():
        text = src
        for cfg, args in repl.items():
            text, n = re.subn(rf"using {cfg} = Cfg<[^>]*>;",
                              f"using {cfg} = Cfg<{args}>;", text)
            if n != 1:
                raise RuntimeError(f"qmm.cu: no single `using {cfg}` line")
        texts[name] = text
    return texts


def f32_i8_runner(lib, x, qt):
    """qmm_i8 of a build with the f32 interface: (x f32, qs, scale, bias, y,
    M, N, K, group, stream)."""
    f = lib.qmm_i8
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    xf = x.float().contiguous()
    (m, k), n = x.shape, qt.shape[0]
    P = _build.ptr

    def run():
        y = torch.empty((m, n), dtype=torch.float32, device=x.device)
        _build.check(f(P(xf), P(qt.qs), P(qt.scale),
                       None if qt.bias is None else P(qt.bias), P(y), m, n, k,
                       qt.group, _build.stream_ptr(x.device)), "qmm_i8 (f32)")
        return y

    return run


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("qmm_ab: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    with open(os.path.join(_build.CSRC, "qmm.cu")) as fh:
        texts = {"shipped": fh.read()}
    shapes = SHAPES
    if argv[:1] == ["--against"]:
        with open(os.path.join(argv[1], "qmm.cu")) as fh:
            texts["other"] = fh.read()
    elif argv == ["--layouts"]:
        shapes = LAYOUT_SHAPES
    elif not argv:
        texts = variant_texts()
    else:
        raise SystemExit("qmm_ab: no options, --against DIR or --layouts")
    f32_i8 = {name for name, text in texts.items() if F32_I8 in text}
    libs = build(texts)
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    timer = Timer(20)
    weights = []
    for sname, kind, group, has_bias, n, k in shapes:
        if kind == "nib4":
            qs = torch.randint(0, 256, (n, k // 2), generator=gen, device=dev,
                               dtype=torch.uint8)
        else:  # Q6_K's values
            qs = torch.randint(-32, 32, (n, k), generator=gen, device=dev,
                               dtype=torch.int8)
        scale = torch.rand((n, k // group), generator=gen, device=dev) * 2e-3 + 1e-4
        bias = (-(torch.rand((n, k // group), generator=gen, device=dev) * 2e-2)
                if has_bias else None)
        weights.append((sname, QTensor(qs=qs, scale=scale, bias=bias,
                                       kind=kind, group=group, shape=(n, k))))
    total = {}
    for order in (list(libs), list(libs)[::-1]):
        for m in (8, 32, 512):
            for sname, qt in weights:
                x = torch.randn((m, qt.shape[1]), generator=gen, device=dev)
                out = []
                for name in order:
                    if qt.kind == "i8" and name in f32_i8:
                        run = f32_i8_runner(libs[name], x, qt)
                        ref = DM.qmatmul_plain(x, qt)
                    else:
                        _build._libs["qmm"] = libs[name]  # qmm_cuda loads it

                        def run():
                            return DM.qmm_cuda(x, qt)

                        ref = DM.qmatmul_twin(x, qt)
                    rel = float((run() - ref).abs().max() / ref.abs().max())
                    if rel > 1e-4:
                        raise AssertionError(f"{name} {sname} M={m}: rel err {rel}")
                    t = timer(run)
                    key = (qt.kind, name, m)
                    total[key] = total.get(key, 0.0) + t / 2
                    out.append(f"{name} {t:.4f}")
                glue = timer(lambda: DM._bf16_operands(x, qt))
                print(f"{sname} M={m}: {' | '.join(out)} ms (glue {glue:.4f}; "
                      f"{qt.nbytes / 1e6:.1f} MB of weights)", flush=True)
    _build._libs.pop("qmm", None)
    if shapes is LAYOUT_SHAPES:
        return 0
    for kind, what in (("nib4", "qmm_nib4, four Q4_K tensors"),
                       ("i8", "qmm_i8, two Q6_K tensors")):
        for m in (8, 32, 512):
            print(f"{what} M={m} (mean of both passes): " + " | ".join(
                f"{name} {total[(kind, name, m)]:.4f}" for name in libs),
                flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
