"""A/B of the attention kernels' score-loop unrolling on the card.

    python -m tpu_engine_torch.tools.attn_ab      # needs one CUDA card

Builds csrc/attn.cu three times with the score loops' ``#pragma unroll 8``
(attn_common.cuh) replaced: removed (the compiler's own choice), 4, and 8
as shipped. Times attn_decode and attn_prefill of each build on f16 "td"
caches at chip_smoke.py's shapes (Llama-2-7B heads: KH=32, D=128), the
builds in turns and the order reversed on a second pass, each launch the
median of 20 after a 256 MB L2 flush, and holds every output against
attention_reference. Prints one line per pass and shape.
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil
import subprocess
import types

import torch

from ..kernels import _build
from ..kernels import flash_attention as FA
from ..kvcache.cache import KVCache
from ..model.llama import attention_reference

UNROLL = "#pragma unroll 8\n"
VARIANTS = {"compiler": "", "unroll4": "#pragma unroll 4\n", "unroll8": UNROLL}
FILLS = [1, 511, 37, 256, 128, 400, 2, 300]
CASES = {  # name: (B, T, starts, Tc, n_valid)
    "decode B=8 fills 1..511": (8, 512, FILLS, 1, [1] * 8),
    "prefill B=1 Tc=512 history 0": (1, 1024, [0], 512, [512]),
    "prefill B=1 Tc=512 history 256": (1, 1024, [256], 512, [512]),
    "prefill B=8 Tc=256 grouped": (8, 512, [0, 0, 130, 0, 256, 17, 0, 200],
                                   256, [256, 24, 0, 0, 150, 0, 256, 0]),
}


def build_variants() -> dict[str, ctypes.CDLL]:
    src = open(os.path.join(_build.CSRC, "attn_common.cuh")).read()
    if src.count(UNROLL) != 2:
        raise RuntimeError("attn_common.cuh: expected two score-loop pragmas")
    procs = {}
    for name, pragma in VARIANTS.items():
        d = os.path.join(_build.BUILD_ROOT, "attn_ab", name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        with open(os.path.join(d, "attn_common.cuh"), "w") as fh:
            fh.write(src.replace(UNROLL, pragma))
        shutil.copy(os.path.join(_build.CSRC, "attn.cu"), d)
        procs[name] = (d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", d, "-o",
             os.path.join(d, "attn.so"), os.path.join(d, "attn.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (d, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {name}:\n{log.decode(errors='replace')}")
        regs = sorted({ln.split("Used ")[1].split(",")[0]
                       for ln in log.decode().splitlines() if "Used " in ln})
        print(f"{name}: {regs}", flush=True)
        libs[name] = ctypes.CDLL(os.path.join(d, "attn.so"))
    return libs


def median_ms(fn, flush, iters=20) -> float:
    for _ in range(2):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for e0, e1 in ev:
        flush.zero_()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sorted(e0.elapsed_time(e1) for e0, e1 in ev)[iters // 2]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("attn_ab: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = build_variants()
    dev, KH, D = "cuda", 32, 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    cfg = types.SimpleNamespace(attention_scale=lambda: 1.0 / math.sqrt(D),
                                attn_logit_softcap=0.0,
                                layer_window=lambda li: 0, rope_dim=D)
    for order in (list(libs), list(libs)[::-1]):
        for cname, (B, T, starts, Tc, n_valid) in CASES.items():
            planes = [torch.randn((1, B, KH, T, D), generator=gen, device=dev)
                      .to(torch.bfloat16) for _ in range(2)]
            st = torch.tensor(starts, dtype=torch.int32, device=dev)
            cache = KVCache(planes[0], planes[1], st.clone(), kind="f16")
            slots = torch.arange(B, dtype=torch.int32, device=dev)
            nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
            q = torch.randn((B, Tc, KH, D), generator=gen, device=dev)
            kn, vn = (torch.randn((B, KH, Tc, D), generator=gen, device=dev)
                      for _ in range(2))
            q_pos = st[:, None] + torch.arange(Tc, dtype=torch.int32,
                                               device=dev)[None]
            ref = attention_reference(q, cache, 0, slots, q_pos, nv, kn, vn,
                                      cfg, rot_cache=True)
            live = (nv > 0) | (st > 0)
            kname = "attn_decode" if Tc == 1 else "attn_prefill"
            out = []
            for name in order:
                _build._libs["attn"] = libs[name]  # FA's launcher loads it

                def run():
                    return FA.attn_kernel(kname, q, kn, vn, cache, 0, slots,
                                          st, nv, 0, cfg.attention_scale(), 0.0)

                err = float((run()[live] - ref[live]).abs().max())
                if err > 2e-4:
                    raise AssertionError(f"{name} {cname}: max abs err {err}")
                out.append(f"{name} {median_ms(run, flush):.4f} ms")
            print(f"{cname}: {' | '.join(out)}", flush=True)
    _build._libs.pop("attn", None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
