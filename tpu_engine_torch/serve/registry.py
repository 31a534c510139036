"""Multi-model engine registry — the LlamaEngine analog (PyTorch port).

A device grid (tensor_parallel x data_parallel above 1x1) is served by
one process a rank (dist/multihost.py): this process becomes rank 0 and
runs the engine; it spawns the other ranks (the spawn start method: it
may already hold a CUDA context), each of which loads its own slice of
the same GGUF and replays rank 0's device ops. /unloadmodel stops the
followers and leaves the group, so a later grid can load. The devices a
grid may use are the registry's `devices` (default: every attached
card); the backend is nccl on distinct cards, gloo on the CPU, or named
(`backend`): gloo lets ranks share one card. Refusals keep the JAX
package's words. tensor_parallel "auto" resolves to the devices over
data_parallel, as in the JAX package: on one card (or the CPU) that is 1,
served unsharded. One grid serves at a time (its ranks are processes
holding the devices). An `mmproj` (LLaVA's CLIP vision tower and
projector) loads onto the registry's device (a grid's rank 0 device)
beside the LLM, raises the context to 2048 cells (4096 for llava-1.6
anyres), and the engine serves images in chat prompts; on a grid the
image rows travel to the other ranks with the step that consumes them. A
non-causal GGUF (bert, nomic-bert) is served by serve/encoder.
EncoderEngine, whole on the first device even when a grid is asked for,
as the JAX registry serves it; a causal one loaded with `model_type:
"embedding"` by InferenceEngine's embedding path (a grid's leader
engine too), without warm-up.
cache_type f16, q8_0 and q4_0 are served; an unknown type warns and falls
back to f16, as the reference does. grp_attn_n > 1 (self-extend) is
served: K is then stored unrotated and the attention kernels rotate it by
the remapped cell positions.

Rebuilds the reference's model lifecycle (SURVEY.md section 2a "LlamaEngine";
reference src/llama_engine.cc): /loadmodel JSON -> engine options
(:547-732), model registry keyed by model id (llama_engine.h:68-85),
warm-up (:1247-1267), status/inventory (:447-504), force-stop set
(:1278-1298).
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import threading
import time

import torch

from ..api.openai import ModelPrompts
from ..model.loader import LoadedModel, load_model
from .encoder import EncoderEngine
from .engine import InferenceEngine
from .types import CompletionParams

log = logging.getLogger("tpu_engine.registry")

# KV cache types the reference accepts (llama_engine.cc:25-47: f16/q8_0/q4_0)
VALID_KV_TYPES = {"f16", "q8_0", "q4_0"}


def get_model_id(body: dict) -> str:
    """Reference: llama_utils::GetModelId (llama_utils.h:153-177):
    model -> model_alias -> basename(llama_model_path|model_path)."""
    for key in ("model", "model_alias"):
        v = body.get(key)
        if v:
            return str(v)
    for key in ("llama_model_path", "model_path"):
        v = body.get(key)
        if v:
            base = os.path.basename(str(v))
            return base[:-5] if base.endswith(".gguf") else base
    return ""


class ModelEntry:
    def __init__(self, model_id: str, engine: InferenceEngine | EncoderEngine,
                 model: LoadedModel, prompts: ModelPrompts, opts: dict):
        self.model_id = model_id
        self.engine = engine
        self.model = model
        self.prompts = prompts
        self.opts = opts
        self.start_time = time.time()
        self.vram_bytes = model.model_size_bytes  # device-resident weights
        self.ram_bytes = 0
        self.grid: Grid | None = None  # the follower ranks of a grid load

    def release(self) -> None:
        """Stop the engine, then the grid's followers (if any)."""
        try:
            self.engine.shutdown()
        finally:
            if self.grid is not None:
                self.grid.close()


class Grid:
    """The processes of a tensor x data parallel load: this process is
    rank 0, `procs` the spawned follower ranks, `store` the directory of
    the group's rendezvous file."""

    def __init__(self, world: int, devices: list, backend: str):
        import multiprocessing as mp

        from ..dist import multihost

        self.store = tempfile.mkdtemp(prefix="tpu_engine_grid_")
        init = "file://" + os.path.join(self.store, "rendezvous")
        ctx = mp.get_context("spawn")
        self.procs = [
            ctx.Process(target=multihost.follower_main, daemon=True,
                        args=(r, world, init, backend, devices))
            for r in range(1, world)]
        for p in self.procs:
            p.start()
        try:
            multihost.initialize(init, world, 0, backend, devices)
            self.channel = multihost.OpChannel()
        except BaseException:
            self.close()
            raise

    def close(self, timeout: float = 60.0) -> None:
        """Leave the process group (a follower still waiting on it then
        raises and exits), join the followers (killing any still running
        after timeout), remove the rendezvous directory."""
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        deadline = time.time() + timeout
        for p in self.procs:
            p.join(max(deadline - time.time(), 0.1))
        for p in self.procs:
            if p.is_alive():
                log.error("grid follower pid %d did not exit; killing it",
                          p.pid)
                p.kill()
                p.join(10)
        shutil.rmtree(self.store, ignore_errors=True)


def _precheck_tp(path: str, p: int):
    """validate_tp's refusal that the GGUF header decides, before any
    process is spawned: the head counts (an encoder's too, as in the JAX
    registry). Returns the model's config. A stored fused q|k|v or
    gate|up (phi3) is split by the loader under TP."""
    from ..dist.tp import validate_heads
    from ..gguf.reader import read_gguf
    from ..model.config import ModelConfig

    g = read_gguf(path)
    try:
        cfg = ModelConfig.from_gguf_metadata(g.metadata)
    finally:
        g.close()
    validate_heads(cfg, p)
    return cfg


class EngineRegistry:
    """Thread-safe model_id -> engine map (reference server_map_,
    llama_engine.h:84-85). device: where models load ("cuda" by default;
    "cpu" runs the plain PyTorch path). devices: the devices a
    tensor x data parallel grid may use, one a rank (default: every
    attached card; a device may repeat under gloo). backend: the grid's
    torch.distributed backend (None: nccl on CUDA, gloo on the CPU)."""

    def __init__(self, device: str = "cuda", devices=None,
                 backend: str | None = None):
        self.device = device
        self.devices = None if devices is None else [str(d) for d in devices]
        self.backend = backend
        self._models: dict[str, ModelEntry] = {}
        self._lock = threading.Lock()
        self._force_stop: set[str] = set()  # reference fsi_mtx_/force-stop set
        self.n_chats = 0
        self.start_time = time.time()

    # -- lifecycle -----------------------------------------------------------
    def load_model(self, body: dict) -> tuple[bool, str]:
        """Reference: LoadModel/LoadModelImpl (llama_engine.cc:363-423,547-732)."""
        model_id = get_model_id(body)
        if not model_id:
            return False, "No model id found in request"
        with self._lock:
            if model_id in self._models:
                # reference behavior: warn + success (llama_engine.cc:371-380)
                return True, f"Model {model_id} already loaded"
        path = body.get("llama_model_path") or body.get("model_path")
        if not path or not os.path.exists(path):
            return False, f"Model path does not exist: {path}"

        # log knobs (reference EngineLoadOption, enginei.h:15-25: log path,
        # max log lines, log level — consumable at load time here since we
        # have no separate engine-dylib Load step)
        if body.get("log_path"):
            self.set_file_logger(int(body.get("max_log_lines", 100_000)),
                                 str(body["log_path"]))
        if body.get("log_level"):
            self.set_log_level(str(body["log_level"]))

        cache_type = str(body.get("cache_type", "f16")).lower()
        if cache_type not in VALID_KV_TYPES:
            log.warning("unsupported cache_type %s, using f16", cache_type)
            cache_type = "f16"
        # q8_0/q4_0 KV is stored in the "dt" layout (kvcache.default_layout)
        # and served by attn_decode_dt / attn_prefill_dt on the card; with
        # grp_attn_n > 1 by the *_rope kernels of the same layout
        # the device grid, resolved as the JAX package resolves it: "auto"
        # takes every attached device not used for data parallelism
        tp_req = body.get("tensor_parallel", 1)
        dp_size = int(body.get("data_parallel", 1))
        if self.devices is not None:
            devices = self.devices
        elif self.device.startswith("cuda"):
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        else:
            devices = [self.device]
        n_dev = len(devices)
        tp_size = (n_dev // max(dp_size, 1) if str(tp_req) == "auto"
                   else int(tp_req))
        if tp_size < 1 or dp_size < 1:
            return False, (f"tensor_parallel={tp_size} x data_parallel="
                           f"{dp_size} is not a valid grid for {n_dev} "
                           f"attached devices")
        # the CUDA kernels (kernels/dequant_matmul.py, flash_attention.py)
        # are the model's default path: they launch on CUDA tensors; the
        # plain PyTorch versions run only on CPU tensors

        n_ctx = int(body.get("ctx_len", 2048))
        n_parallel = int(body.get("n_parallel", 1))
        model_type = str(body.get("model_type", "llm"))
        is_embedding = bool(body.get("embedding", model_type == "embedding"))

        grid_devices = None  # the ranks' devices when a grid is served
        device = self.device  # where this process loads the model (rank 0)
        cfg = None  # the grid model's config, read from the GGUF header
        if tp_size > 1 or dp_size > 1:
            if tp_size * dp_size > n_dev:
                return False, (f"tensor_parallel={tp_size} x data_parallel="
                               f"{dp_size} but only {n_dev} devices attached")
            if dp_size > 1 and n_parallel % dp_size:
                return False, (f"data_parallel={dp_size} requires n_parallel "
                               f"({n_parallel}) divisible by it")
            try:
                cfg = _precheck_tp(str(path), tp_size)
            except ValueError as e:
                return False, str(e)
            # an encoder (bert, nomic-bert) is served whole on the grid's
            # first device, with no process spawned: the JAX registry's
            # encoder path returns before its mesh is used
            device = devices[0]
        if cfg is not None and cfg.causal:
            with self._lock:
                busy = [e.model_id for e in self._models.values() if e.grid]
            if busy:
                return False, (f"a device grid is already serving {busy[0]}; "
                               "unload it first")
            try:
                grid_devices = devices[:tp_size * dp_size]
                from ..dist.tp import check_backend, default_backend

                backend = self.backend or default_backend(grid_devices)
                check_backend(backend, grid_devices)
            except ValueError as e:
                return False, str(e)

        lm = None  # a grid's rank 0 loads its slice in start_leader
        if grid_devices is None:
            try:
                lm = load_model(str(path), device=device)
            except NotImplementedError as e:
                return False, str(e)

        # multimodal: mmproj clip model (reference LoadModel,
        # llama_server_context.cc:182-242), on rank 0's device under a grid
        clip = None
        mmproj = body.get("mmproj")
        if mmproj:
            if not os.path.exists(str(mmproj)):
                return False, f"mmproj path does not exist: {mmproj}"
            from ..clipvit.model import load_clip

            try:
                clip = load_clip(str(mmproj), device=device)
            except Exception as e:
                return False, f"unable to load clip model: {e}"
            n_embd = (lm.cfg if lm is not None else cfg).n_embd
            if clip.n_embd_out != n_embd:
                return False, (
                    f"embedding dim of the multimodal projector "
                    f"({clip.n_embd_out}) is not equal to that of the LLM "
                    f"({n_embd}); use the matching mmproj file")
            # images need room (reference :195-205: >=2048; llava-1.6 4096)
            min_ctx = 4096 if clip.cfg.is_anyres else 2048
            if n_ctx < min_ctx:
                n_ctx = min_ctx

        if lm is not None and not lm.cfg.causal:
            # bidirectional embedding model (bert family, the reference's
            # nomic-embed flow): the encoder engine, no decode loop
            engine = EncoderEngine(lm, n_ctx=n_ctx)
            try:
                engine.warm_up()
            except Exception as e:  # warm-up failure is fatal for the load
                return False, f"warm-up failed: {e}"
            opts = {
                "caching_enabled": False,
                "model_type": "embedding",
                "embedding": True,
                "grammar": "",
                "ctx_len": engine.n_ctx,
                "n_parallel": 1,
            }
            entry = ModelEntry(model_id, engine, lm, ModelPrompts(), opts)
            entry.load_body = dict(body)
            with self._lock:
                self._models[model_id] = entry
            log.info("embedding model %s loaded (pooling=%s)",
                     model_id, lm.cfg.pooling_type)
            return True, f"Model {model_id} loaded successfully"

        # knob parity with the reference's LoadModelImpl
        # (llama_engine.cc:569-570,610,618,649-650): n_ubatch maps to our
        # prefill bucket cap (the jitted-chunk analog of ggml's micro-
        # batch); ngl / use_mmap / mlock are device-memory knobs with no
        # TPU meaning (weights are always device-resident; PARITY.md §2c)
        # — acknowledged and logged, never silently dropped.
        n_batch = int(body.get("n_batch", 2048))
        n_ubatch = int(body.get("n_ubatch", n_batch))
        for knob in ("ngl", "use_mmap", "mlock"):
            if knob in body:
                log.info("load knob %s=%r acknowledged: not applicable "
                         "(weights are device-resident)",
                         knob, body[knob])
        grammar_file = str(body.get("grammar_file", ""))
        grammar_text = ""
        if grammar_file:
            try:
                with open(grammar_file) as f:
                    grammar_text = f.read()
            except OSError as e:
                return False, f"cannot read grammar_file: {e}"

        engine_kw = dict(
            n_ctx=n_ctx,
            n_parallel=n_parallel,
            n_batch=min(n_batch, n_ubatch),
            cont_batching=bool(body.get("cont_batching", True)),
            ctx_shift=bool(body.get("ctx_shift", True)),
            grp_attn_n=int(body.get("grp_attn_n", 1)),
            grp_attn_w=int(body.get("grp_attn_w", 512)),
            cache_type=cache_type,
        )
        grid = None
        if grid_devices is None:
            engine = InferenceEngine(lm, clip=clip, **engine_kw)
        else:
            # rank 0 of the grid: the engine on this rank's slice, its ops
            # broadcast to the followers (dist/multihost.start_leader)
            from ..dist.multihost import start_leader

            if torch.device(grid_devices[0]).type == "cuda":
                # the followers load the built kernels, never build them
                from ..kernels import _build

                _build.build_all()
            grid = Grid(tp_size * dp_size, grid_devices, backend)
            try:
                engine = start_leader(
                    str(path), tp_size, channel=grid.channel,
                    data_parallel=dp_size, devices=grid_devices, clip=clip,
                    **engine_kw)
            except Exception as e:
                grid.close()
                log.error("grid load of %s failed: %s", model_id, e)
                return False, str(e)
        prompts = ModelPrompts(
            user_prompt=str(body.get("user_prompt", "USER: ")),
            ai_prompt=str(body.get("ai_prompt", "ASSISTANT: ")),
            system_prompt=str(body.get("system_prompt", "ASSISTANT's RULE: ")),
            pre_prompt=str(body.get("pre_prompt", "")),
        )
        opts = {
            "caching_enabled": bool(body.get("caching_enabled", True)),
            "model_type": model_type,
            "embedding": is_embedding,
            "grammar": grammar_text,
            "ctx_len": n_ctx,
            "n_parallel": n_parallel,
        }
        if grid is not None:
            opts.update(tensor_parallel=tp_size, data_parallel=dp_size)
        entry = ModelEntry(model_id, engine, engine.model, prompts, opts)
        entry.grid = grid
        entry.load_body = dict(body)  # preemption-tolerant reload recipe
        with self._lock:
            self._models[model_id] = entry
        if model_type == "llm":
            try:
                engine.warm_up()
            except Exception as e:  # warm-up failure is fatal for the load
                with self._lock:
                    self._models.pop(model_id, None)
                entry.release()
                return False, f"warm-up failed: {e}"
        if grid is None:
            log.info("model %s loaded", model_id)
        else:
            log.info("model %s loaded on a %dx%d grid (tensor_parallel x "
                     "data_parallel) over %s", model_id, tp_size, dp_size,
                     grid_devices)
        return True, f"Model {model_id} loaded successfully"

    def unload_model(self, model_id: str) -> tuple[bool, str]:
        with self._lock:
            entry = self._models.pop(model_id, None)
        if entry is None:
            return False, f"Model {model_id} has not been loaded"
        entry.release()
        return True, f"Model {model_id} unloaded successfully"

    def get(self, model_id: str) -> ModelEntry | None:
        with self._lock:
            return self._models.get(model_id)

    def check_loaded(self, model_id: str) -> ModelEntry | None:
        """Reference: CheckModelLoaded (llama_engine.cc:1225-1245), plus
        preemption tolerance (SURVEY.md section 5 TPU addition): an engine
        marked failed (device lost / repeated runtime errors) is torn down
        and the model reloaded from its GGUF before serving."""
        entry = self.get(model_id)
        if entry is not None and getattr(entry.engine, "failed", False):
            log.warning("engine for %s failed; reloading model", model_id)
            body = getattr(entry, "load_body", None)
            with self._lock:
                self._models.pop(model_id, None)
            try:
                entry.release()
            except Exception:
                pass
            if not body:
                return None
            ok, msg = self.load_model(body)
            if not ok:
                log.error("preemption reload of %s failed: %s", model_id, msg)
                return None
            return self.get(model_id)
        return entry

    def metrics_text(self) -> str:
        """Prometheus text exposition of the serving counters (beyond the
        reference, which only has no_of_requests_/no_of_chats_ internals —
        llama_engine.h:90-91)."""
        import time as _t

        with self._lock:
            total_requests = sum(
                e.engine.n_requests for e in self._models.values())
        lines = [
            "# TYPE tpu_engine_requests_total counter",
            f"tpu_engine_requests_total {total_requests}",
            "# TYPE tpu_engine_chats_total counter",
            f"tpu_engine_chats_total {self.n_chats}",
            "# TYPE tpu_engine_uptime_seconds gauge",
            f"tpu_engine_uptime_seconds {_t.time() - self.start_time:.1f}",
            "# TYPE tpu_engine_models_loaded gauge",
        ]
        with self._lock:
            entries = list(self._models.values())
        lines.append(f"tpu_engine_models_loaded {len(entries)}")
        lines.append("# TYPE tpu_engine_slots_busy gauge")
        lines.append("# TYPE tpu_engine_engine_requests_total counter")
        for e in entries:
            busy = sum(1 for sl in e.engine.slots if sl.is_processing())
            lines.append(
                f'tpu_engine_slots_busy{{model="{e.model_id}"}} {busy}')
            lines.append(
                f'tpu_engine_engine_requests_total{{model="{e.model_id}"}} '
                f"{e.engine.n_requests}")
        return "\n".join(lines) + "\n"

    def model_status(self, model_id: str) -> dict | None:
        entry = self.get(model_id)
        if entry is None:
            return None
        return {
            "model_loaded": True,
            "model_data": {
                "frame_count": 0,
                "ctx_len": entry.opts["ctx_len"],
                "n_parallel": entry.opts["n_parallel"],
            },
        }

    def list_models(self) -> list[dict]:
        """Reference: GetModels (llama_engine.cc:447-504) incl. the custom
        ram/vram patch (patches/0001-Add-API-query-buffer-size.patch)."""
        out = []
        with self._lock:
            entries = list(self._models.values())
        for e in entries:
            out.append({
                "id": e.model_id,
                "engine": "tpu-engine-torch",
                "start_time": int(e.start_time * 1000),
                "vram": str(e.vram_bytes),
                "ram": str(e.ram_bytes),
                "object": "model",
                "model_size": str(e.model.model_size_bytes),
            })
        return out

    def unload_all(self) -> None:
        with self._lock:
            entries = list(self._models.values())
            self._models.clear()
        for e in entries:
            e.release()

    # -- force stop (reference llama_engine.cc:506-508, 1278-1298) ----------
    def set_file_logger(self, max_lines: int, path: str) -> None:
        """EngineI::SetFileLogger analog (reference base/cortex-common/
        enginei.h:64-66): route all tpu_engine logs into a circular
        (line-capped) file, replacing any previous file handler."""
        from ..utils.logger import CircularFileHandler

        root = logging.getLogger("tpu_engine")
        for h in list(root.handlers):
            if isinstance(h, CircularFileHandler):
                root.removeHandler(h)
                h.close()
        handler = CircularFileHandler(path, max_lines or 100_000)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s %(message)s"))
        root.addHandler(handler)
        log.info("file logger -> %s (max %d lines)", path, max_lines)

    def set_log_level(self, level: str) -> None:
        """EngineI::SetLogLevel analog (enginei.h:67)."""
        logging.getLogger("tpu_engine").setLevel(level.upper())

    def stop_inferencing(self, model_id: str) -> None:
        self._force_stop.add(model_id)

    def should_stop(self, model_id: str) -> bool:
        return model_id in self._force_stop

    def clear_stop(self, model_id: str) -> None:
        self._force_stop.discard(model_id)
