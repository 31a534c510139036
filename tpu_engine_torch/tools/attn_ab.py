"""A/B of the attention kernels on the card.

    python -m tpu_engine_torch.tools.attn_ab --against DIR  # needs one CUDA card
    python -m tpu_engine_torch.tools.attn_ab --fills

With --against DIR: builds the four attention sources (attn.cu,
attn_dt.cu, attn_rope.cu, attn_dt_rope.cu) as shipped and as they are in
DIR (the csrc/ of another checkout, e.g. the parent commit unpacked with
git archive; their C interface this one's or the one before the decode
workspace), and times every kernel at chip_smoke.py's shapes: decode B=8 fills 1..511
and fills 4..2047 at T=2048, prefill B=1 Tc=512 at history 0 and 256
and the grouped B=8 Tc=256 step, f16 "td" and q8_0/q4_0 "dt", K stored
rotated and unrotated. Shapes are Llama-2-7B heads (KH=32, G=1,
D=128). The builds run in turns and the order reversed on a second pass,
each time the median of 20 launches (tools/timing.py), and every output
is held against attention_reference. A DIR whose C interface predates the
decode workspace (no ``ws`` argument) is called through a shim that drops
it, so a tree and its parent run in one process. With --fills: times
attn_decode as shipped, f16 "td", B=8 KH=32 G=1 D=128 T=512, at uniform
fills (every row at 31, 255 or 511 cells) and at the mixed FILLS, to show
whether its time follows the longest row or the total of live cells.
Prints one line per pass and case.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import torch

from ..kernels import _build
from ..kernels import flash_attention as FA
from ..kvcache.cache import QUANT_KINDS, KVCache, quantize_kv_rows
from ..model.config import ModelConfig
from ..model.llama import attention_reference
from .timing import Timer

LIBS = ("attn", "attn_dt", "attn_rope", "attn_dt_rope")
FILLS = [1, 511, 37, 256, 128, 400, 2, 300]
CASES = {  # name: (B, T, starts, Tc, n_valid)
    "decode B=8 fills 1..511": (8, 512, FILLS, 1, [1] * 8),
    "decode B=8 T=2048 fills 4..2047": (
        8, 2048, [4, 2047, 148, 1024, 512, 1600, 8, 1200], 1, [1] * 8),
    "prefill B=1 Tc=512 history 0": (1, 1024, [0], 512, [512]),
    "prefill B=1 Tc=512 history 256": (1, 1024, [256], 512, [512]),
    "prefill B=8 Tc=256 grouped": (8, 512, [0, 0, 130, 0, 256, 17, 0, 200],
                                   256, [256, 24, 0, 0, 150, 0, 256, 0]),
}
AGAINST_CASES = [  # (case, kind, layout)
    (case, kind, layout) for case in CASES
    for kind, layout in (("f16", "td"), ("q8_0", "dt"), ("q4_0", "dt"))]
FILL_CASES = {f"decode B=8 fills all {f}": (8, 512, [f] * 8, 1, [1] * 8)
              for f in (31, 255, 511)}
FILL_CASES["decode B=8 fills 1..511"] = CASES["decode B=8 fills 1..511"]


WS_ARG = "void* ws"  # the decode workspace in ATTN_ENTRY's parameters


def common_text() -> str:
    with open(os.path.join(_build.CSRC, "attn_common.cuh")) as fh:
        return fh.read()


class _NoWorkspace:
    """A library built from a tree whose ATTN_ENTRY has no workspace
    argument: each entry point is called with the workspace (the argument
    before the stream) dropped."""

    def __init__(self, cdll):
        self.cdll = cdll

    def __getattr__(self, name):
        f = getattr(self.cdll, name)
        f.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int]
                      + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                      + [ctypes.c_float, ctypes.c_float]
                      + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int

        def call(*a):
            return f(*a[:-2], a[-1])

        call.argtypes = f.argtypes
        return call


def build(trees: dict[str, tuple[str, str]], libs) -> dict[str, dict]:
    """trees: name -> (directory of the .cu sources, attn_common.cuh
    text); builds each of libs there, in parallel."""
    procs = []
    for name, (src_dir, common) in trees.items():
        d = os.path.join(_build.BUILD_ROOT, "attn_ab", name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        with open(os.path.join(d, "attn_common.cuh"), "w") as fh:
            fh.write(common)
        for lib in libs:
            shutil.copy(os.path.join(src_dir, lib + ".cu"), d)
            procs.append((name, lib, d, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", d, "-o",
                 os.path.join(d, lib + ".so"), os.path.join(d, lib + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    out: dict[str, dict] = {name: {} for name in trees}
    for name, lib, d, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {name} {lib}:\n{log.decode(errors='replace')}")
        cdll = ctypes.CDLL(os.path.join(d, lib + ".so"))
        old = WS_ARG in common_text() and WS_ARG not in trees[name][1]
        out[name][lib] = _NoWorkspace(cdll) if old else cdll
    return out


def make_case(gen, B, T, starts, Tc, n_valid, kind, layout, KH=32, D=128):
    dev = "cuda"
    planes, scales = [], []
    for _ in range(2):
        x = torch.randn((1, B, KH, T, D), generator=gen, device=dev)
        if kind in QUANT_KINDS:
            x, s = quantize_kv_rows(x, kind)
            scales.append(s)
        else:
            x = x.to(torch.bfloat16)
        planes.append(x.transpose(-1, -2).contiguous() if layout == "dt" else x)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    cache = KVCache(planes[0], planes[1], st.clone(), *(scales or (None, None)),
                    kind=kind, layout=layout)
    q = torch.randn((B, Tc, KH, D), generator=gen, device=dev)
    kn, vn = (torch.randn((B, KH, Tc, D), generator=gen, device=dev)
              for _ in range(2))
    return (q, cache, torch.arange(B, dtype=torch.int32, device=dev),
            st[:, None] + torch.arange(Tc, dtype=torch.int32, device=dev)[None],
            torch.tensor(n_valid, dtype=torch.int32, device=dev), kn, vn)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("attn_ab: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    common = common_text()
    if argv[:1] == ["--against"]:
        other = argv[1]
        with open(os.path.join(other, "attn_common.cuh")) as fh:
            trees = {"shipped": (_build.CSRC, common), "other": (other, fh.read())}
        libs, cases, ropes = LIBS, AGAINST_CASES, (False, True)
    elif argv[:1] == ["--fills"]:
        trees = {"shipped": (_build.CSRC, common)}
        libs, ropes = ("attn",), (False,)
        cases = [(c, "f16", "td") for c in FILL_CASES]
    else:
        raise SystemExit("attn_ab: give --against DIR or --fills")
    built = build(trees, libs)
    by_pair = FA._by_pair
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    timer = Timer(20)
    cfg = attn_cfg(128)
    for order in (list(built), list(built)[::-1]):
        for cname, kind, layout in cases:
            args = make_case(gen, *{**CASES, **FILL_CASES}[cname], kind, layout)
            q, cache, slots, q_pos, nv, kn, vn = args
            live = (nv > 0) | (q_pos[:, 0] > 0)
            for rope in ropes:
                tables = (FA.cache_rope_tables(cache, cfg, 4, 128)
                          if rope else None)
                ref = attention_reference(
                    q, cache, 0, slots, q_pos, nv, kn, vn, cfg,
                    *((4, 128) if rope else (1, 0)), rot_cache=not rope)
                kname = ("attn_decode" if q.shape[1] == 1 else "attn_prefill"
                         ) + ("_dt" if layout == "dt" else "") + (
                             "_rope" if rope else "")
                out = []
                for name in order:
                    for lib, cdll in built[name].items():
                        _build._libs[lib] = cdll  # FA's launchers load it
                    # a build before the workspace reads [T, rd/2] tables
                    # in every entry point
                    old = any(isinstance(c, _NoWorkspace)
                              for c in built[name].values())
                    FA._by_pair = (lambda cache, t: t) if old else by_pair

                    def run():
                        return FA.attn_kernel(
                            kname, q, kn, vn, cache, 0, slots, q_pos[:, 0].contiguous(),
                            nv, 0, cfg.attention_scale(), 0.0, tables=tables)

                    err = float((run()[live] - ref[live]).abs().max())
                    if err > 2e-4:
                        raise AssertionError(f"{name} {kname} {cname}: max abs err {err}")
                    out.append(f"{name} {timer(run):.4f} ms")
                print(f"{kname} {kind} {layout} {cname}: {' | '.join(out)}",
                      flush=True)
    FA._by_pair = by_pair
    for lib in libs:
        _build._libs.pop(lib, None)
    return 0


def attn_cfg(D):
    """Attention's part of a Llama config at head_dim D (as chip_smoke.py's
    attn_cfg): 1/sqrt(D) scale, split-half rope over D, theta 10000."""
    return ModelConfig(
        arch="llama", n_layer=1, n_embd=32 * D, n_head=32, n_kv_head=32,
        head_dim=D, n_ff=4 * D, n_vocab=32, n_ctx_train=4096, rms_eps=1e-5,
        rope_theta=10000.0, rope_dim=D, rope_type="neox")


if __name__ == "__main__":
    raise SystemExit(main())
