"""A/B of qmm_nib4's tile configurations on the card.

    python -m tpu_engine_torch.tools.qmm_ab      # needs one CUDA card

Builds csrc/qmm.cu once as shipped and once per variant below, each with
one tile configuration (the ``using DecCfg/MidCfg/PreCfg = Cfg<...>;``
lines) replaced, all builds in parallel. Times qmm_nib4 through
qmm_cuda (the bf16 cast and group sums included, the same in every
build) on the four Q4_K tensors of a Llama-2-7B layer at M = 8, 32 and
512, the builds in turns and the order reversed on a second pass, each
time the median of 20 launches (tools/timing.py: device time after a
256 MB L2 flush), and holds every
output against qmm_nib4_plain. Prints one line per pass and shape, and
the sum over the four tensors per build and M.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess

import torch

from ..kernels import _build
from ..kernels import dequant_matmul as DM
from ..model.weights import QTensor
from .timing import Timer

# variant -> {config name: its Cfg<...> template arguments}
VARIANTS = {
    "shipped": {},
    # decode: 16 weight rows (x padded to 16), 512-wide chunks, three
    # stages, two blocks an SM; the same with K split 4 ways; 32 rows with
    # 512-wide chunks
    "dec_bn16": {"DecCfg": "16, 16, 16, 16, 8, 512, 3, 16, 16, 2"},
    "dec_bn16_ksplit4": {"DecCfg": "16, 16, 16, 16, 4, 256, 3, 16, 16, 3"},
    "dec_kc512": {"DecCfg": "32, 8, 32, 8, 8, 512, 3, 32, 8, 1"},
    # M 9..64: K split 8 ways; M > 64: 64-wide chunks, three stages
    "mid_ksplit8": {"MidCfg": "32, 32, 32, 32, 8, 256, 3, 16, 16, 1"},
    "pre_kc64": {"PreCfg": "128, 128, 64, 32, 1, 64, 3, 16, 16, 1"},
}
SHAPES = [("wqkv", 12288, 4096), ("wo", 4096, 4096),
          ("w_gateup", 22016, 4096), ("w_down", 4096, 11008)]


def build_variants() -> dict[str, ctypes.CDLL]:
    src = open(os.path.join(_build.CSRC, "qmm.cu")).read()
    procs = {}
    for name, repl in VARIANTS.items():
        text = src
        for cfg, args in repl.items():
            text, n = re.subn(rf"using {cfg} = Cfg<[^>]*>;",
                              f"using {cfg} = Cfg<{args}>;", text)
            if n != 1:
                raise RuntimeError(f"qmm.cu: no single `using {cfg}` line")
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("qmm_ab: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = build_variants()
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    timer = Timer(20)
    weights = []
    for sname, n, k in SHAPES:
        qs = torch.randint(0, 256, (n, k // 2), generator=gen, device=dev,
                           dtype=torch.uint8)
        scale = torch.rand((n, k // 32), generator=gen, device=dev) * 2e-3 + 1e-4
        bias = -(torch.rand((n, k // 32), generator=gen, device=dev) * 2e-2)
        weights.append((sname, QTensor(qs=qs, scale=scale, bias=bias,
                                       kind="nib4", group=32, shape=(n, k))))
    total = {}
    for order in (list(libs), list(libs)[::-1]):
        for m in (8, 32, 512):
            for sname, qt in weights:
                x = torch.randn((m, qt.shape[1]), generator=gen, device=dev)
                ref = DM.qmm_nib4_plain(x, qt)
                scale = float(ref.abs().max())
                out = []
                for name in order:
                    _build._libs["qmm"] = libs[name]  # qmm_cuda loads it

                    def run():
                        return DM.qmm_cuda(x, qt)

                    rel = float((run() - ref).abs().max()) / scale
                    if rel > 1e-4:
                        raise AssertionError(f"{name} {sname} M={m}: rel err {rel}")
                    t = timer(run)
                    total[(name, m)] = total.get((name, m), 0.0) + t / 2
                    out.append(f"{name} {t:.4f}")
                glue = timer(lambda: DM._nib4_operands(x, qt))
                print(f"{sname} M={m}: {' | '.join(out)} ms (glue {glue:.4f})",
                      flush=True)
    _build._libs.pop("qmm", None)
    for m in (8, 32, 512):
        print(f"four tensors M={m} (mean of both passes): " + " | ".join(
            f"{name} {total[(name, m)]:.4f}" for name in libs), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
