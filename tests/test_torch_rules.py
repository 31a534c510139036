"""Rules of the PyTorch port (tpu_engine_torch/ and chip_smoke.py):

  - no module imports jax or the JAX package tpu_engine (an AST scan;
    relative imports stay inside the port package);
  - the package imports in a process where importing jax fails;
  - with no CUDA device, an entry point called without device="cpu"
    raises instead of running on the CPU (load_model of causal and
    non-causal GGUFs, the registry's EncoderEngine, the server).
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tpu_engine_torch")


def _port_files() -> list[str]:
    out = []
    for d, _, files in os.walk(PKG):
        out += [os.path.relpath(os.path.join(d, f), ROOT)
                for f in files if f.endswith(".py")]
    return sorted(out) + ["chip_smoke.py"]


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "tpu_engine")


@pytest.mark.parametrize("rel", _port_files())
def test_no_jax_or_tpu_engine_import(rel):
    path = os.path.join(ROOT, rel)
    with open(path) as f:
        tree = ast.parse(f.read(), rel)
    # depth of the module inside the package (relative imports must not
    # climb out of tpu_engine_torch)
    parts = rel.split(os.sep)
    depth = len(parts) - 1 if parts[0] == "tpu_engine_torch" else 0
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                assert not _banned(a.name), f"{rel}:{node.lineno} imports {a.name}"
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                assert not _banned(node.module or ""), \
                    f"{rel}:{node.lineno} imports {node.module}"
            else:
                assert node.level <= depth, \
                    f"{rel}:{node.lineno} relative import leaves the package"


def test_package_imports_without_jax():
    mods = []
    for rel in _port_files():
        if rel == "chip_smoke.py":
            mods.append("chip_smoke")
        else:
            m = rel[:-3].replace(os.sep, ".")
            mods.append(m[: -len(".__init__")] if m.endswith(".__init__") else m)
    code = ("import sys; sys.modules['jax'] = None; sys.modules['tpu_engine'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'tpu_engine.'))\n"
            "               for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")


def test_resolve_device_defaults_to_cuda_and_raises(no_cuda):
    from tpu_engine_torch.utils.device import device_report, resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
    assert device_report("cpu") == {"platform": "cpu", "kind": "cpu", "count": 1}


def test_load_model_without_device_raises(no_cuda, tmp_path):
    from tpu_engine_torch.model.loader import load_model
    from tpu_engine_torch.tools.q4km import build_q4km_gguf

    path = build_q4km_gguf(str(tmp_path / "m.gguf"), "tiny", n_layer=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model(path)
    assert load_model(path, device="cpu").device.type == "cpu"


def test_load_encoder_without_device_raises(no_cuda, tmp_path):
    """load_model of a non-causal GGUF (nomic-bert) defaults to cuda too."""
    from tpu_engine_torch.model.loader import load_model
    from tpu_engine_torch.tools.encoder_gguf import build_nomic_bert_gguf

    path = build_nomic_bert_gguf(str(tmp_path / "e.gguf"), level="f32",
                                 widths=(1, 64, 2, 128, 64, 32))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model(path)
    lm = load_model(path, device="cpu")
    assert not lm.cfg.causal and lm.device.type == "cpu"


def test_registry_encoder_without_device_raises(no_cuda, tmp_path):
    """The registry builds an EncoderEngine for a non-causal GGUF on the
    registry's device: cuda by default (raises here), the CPU only when
    asked, and the engine's tensors lie there."""
    from tpu_engine_torch.serve.encoder import EncoderEngine
    from tpu_engine_torch.serve.registry import EngineRegistry
    from tpu_engine_torch.tools.encoder_gguf import build_nomic_bert_gguf

    path = build_nomic_bert_gguf(str(tmp_path / "e.gguf"), level="f32",
                                 widths=(1, 64, 2, 128, 64, 32))
    body = {"llama_model_path": path, "model": "e", "model_type": "embedding"}
    with pytest.raises(RuntimeError, match="CUDA"):
        EngineRegistry().load_model(dict(body))
    reg = EngineRegistry(device="cpu")
    ok, msg = reg.load_model(dict(body))
    assert ok, msg
    engine = reg.get("e").engine
    assert isinstance(engine, EncoderEngine) and engine.device.type == "cpu"
    reg.unload_all()


def test_server_without_device_raises(no_cuda):
    from tpu_engine_torch.api.server import main, make_server

    with pytest.raises(RuntimeError, match="CUDA"):
        make_server("127.0.0.1", 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--port", "0"])


def test_chip_smoke_refuses_without_cuda(no_cuda):
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
