"""One serving engine over a grid of processes: rank 0 leads, the other
ranks replay its device ops.

The counterpart of the JAX package's dist/multihost.py. Every rank must
run the SAME step with the same shapes in the same order, so that the
collectives of the forward (dist/tp.py) line up. Rank 0 runs the full
serving engine (slots, queues, stop words, scheduling); its per-step
decisions, already funneled through the engine's device-op layer
(serve/ops.py), are published as compact picklable descriptors, and every
other rank replays the identical op sequence on its own weight and KV
slices:

    rank 0:  InferenceEngine -> BroadcastOps.step(...)  --+
                                                          +-- broadcast
    rank k:  serve_follower(): recv -> EngineOps.step(...)+   (gloo)

Result pulls (tokens, logits rows) stay on rank 0: the step functions
return every slot's logits and tokens on every rank.

The op channel is a gloo group of its own, with a long timeout: a
follower waits there for the next op however long the server idles. The
process group of the forward carries the timeout given to initialize, so
a rank that hangs makes the others raise instead of waiting for ever; a
rank that dies closes its connections, which raises at once. Each
process samples for itself from identical logits with the generator
seeded from the leader's published seed, and records what it sampled
and the bits of every step's logits (gathered, so the same on every
rank): verify_state compares the records and the cache lengths across
ranks.

Bring-up on one machine: several processes may share one card over gloo
(or the CPU, as the tests do); serve/registry.py spawns the followers of
a /loadmodel grid with the spawn start method.
"""

from __future__ import annotations

import datetime
import hashlib
import logging
import pickle

import numpy as np
import torch

log = logging.getLogger("tpu_engine.dist.multihost")

# kernel launches the followers reported at shutdown, summed over every
# follower and every grid since the last reset (chip_smoke.py reads them)
FOLLOWER_LAUNCHES: dict[str, int] = {}

# how long a follower waits on the op channel for the leader's next op
CHANNEL_TIMEOUT = datetime.timedelta(days=7)


def initialize(init_method: str, world_size: int, rank: int,
               backend: str | None = None, devices=None,
               timeout_s: float = 600.0) -> None:
    """torch.distributed bring-up of one rank. backend None: nccl when
    every rank's device (devices, one a rank) is CUDA, else gloo; a
    backend the devices cannot run raises (dist/tp.check_backend).
    timeout_s bounds every collective of the forward."""
    import torch.distributed as dist

    from .tp import check_backend, default_backend

    if devices is None:
        from .sharding import attached_devices

        devices = attached_devices()[:world_size]
    devices = [str(d) for d in devices][:world_size]
    if len(devices) < world_size:
        raise ValueError(f"{world_size} ranks but only {len(devices)} "
                         "devices attached")
    backend = backend or default_backend(devices)
    check_backend(backend, devices)
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    log.info("rank %d/%d up on %s (%s)", rank, world_size, dev, backend)


class OpChannel:
    """Ordered broadcast of picklable op descriptors from rank 0, on a
    gloo group of its own (CPU tensors, any backend of the forward). Two
    broadcasts per op: the 8-byte length, then the exact-size payload.
    Every rank constructs it at the same point (it creates a group)."""

    def __init__(self):
        import torch.distributed as dist

        self.group = dist.new_group(backend="gloo", timeout=CHANNEL_TIMEOUT)

    def publish(self, obj) -> None:
        import torch.distributed as dist

        payload = pickle.dumps(obj)
        dist.broadcast(torch.tensor([len(payload)], dtype=torch.int64), 0,
                       group=self.group)
        dist.broadcast(torch.frombuffer(bytearray(payload), dtype=torch.uint8),
                       0, group=self.group)

    def recv(self):
        import torch.distributed as dist

        n = torch.zeros(1, dtype=torch.int64)
        dist.broadcast(n, 0, group=self.group)
        buf = torch.empty(int(n), dtype=torch.uint8)
        dist.broadcast(buf, 0, group=self.group)
        return pickle.loads(buf.numpy().tobytes())

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """all_reduce (sum) of a CPU tensor over every rank."""
        import torch.distributed as dist

        dist.all_reduce(x, group=self.group)
        return x


# ops that mutate shared device state and therefore must replay everywhere;
# pulls are rank 0's alone and deliberately absent
_REPLAYED = ("step", "dloop", "sample_first", "trim", "seq_cp",
             "shift_compact", "clear_all", "set_grammar_bank")


def _launch_counts() -> dict[str, int]:
    from ..kernels import dequant_matmul, extract, flash_attention

    return {**dequant_matmul.LAUNCHES, **flash_attention.LAUNCHES,
            **extract.LAUNCHES}


class _Recorded:
    """Folds every token this process samples, and a checksum of the bits
    of every step's logits, into running digests, so the ranks can be
    compared (verify_state). Both stay on the device until a digest is
    asked for, or 256 entries are pending."""

    def _pend(self, key: str, x: torch.Tensor) -> None:
        pending = self.__dict__.setdefault("_pending", {})
        pending.setdefault(key, []).append(x)
        if len(pending[key]) >= 256:
            self._fold()

    def _record(self, toks):
        self._pend("tokens", toks)
        return toks

    def step(self, *a, **kw):
        logits, pooled = super().step(*a, **kw)
        if logits is not None:
            # position-weighted sum of the logits' bytes: any differing bit
            # changes it (as int64, wrapping is harmless)
            b = logits.detach().contiguous().reshape(-1).view(torch.uint8)
            w = torch.arange(b.numel(), device=b.device, dtype=torch.int64)
            self._pend("logits", ((w % 65521 + 1) * b.to(torch.int64)).sum())
        return logits, pooled

    def _fold(self) -> None:
        d = self.__dict__
        for key, xs in d.pop("_pending", {}).items():
            h = d.setdefault("_digest_" + key, hashlib.sha256())
            for t in xs:
                flat = t.reshape(-1).to("cpu", torch.int64).numpy()
                h.update(flat.tobytes())
                if key == "tokens":
                    d["_n_sampled"] = d.get("_n_sampled", 0) + int(flat.size)

    def _digest(self, key: str) -> int:
        """A 52-bit digest of the entries of `key` in order (exact in the
        float64 state table)."""
        self._fold()
        h = self.__dict__.setdefault("_digest_" + key, hashlib.sha256())
        return int.from_bytes(h.digest()[:8], "little") >> 12

    def token_digest(self) -> tuple[int, int]:
        """(tokens sampled, a 52-bit digest of them in order)."""
        digest = self._digest("tokens")
        return self.__dict__.get("_n_sampled", 0), digest

    def logits_digest(self) -> int:
        """A 52-bit digest of every step's logits, in order."""
        return self._digest("logits")


def _state_row(ops) -> torch.Tensor:
    """This rank's state summary: tokens sampled, their digest, the
    digest of its steps' logits, and the lengths of every slot (the
    rank's own, zeros else)."""
    c = ops.cache
    n_tok, digest = ops.token_digest()
    lengths = torch.zeros(ops.n_slots, dtype=torch.float64)
    lo = 0 if c.slot_shards <= 1 else ops.mesh.data_rank * c.n_slots
    lengths[lo:lo + c.n_slots] = c.lengths.to("cpu", torch.float64)
    head = torch.tensor([n_tok, digest, ops.logits_digest()],
                        dtype=torch.float64)
    return torch.cat([head, lengths])


def _state_table(ops, channel: OpChannel) -> torch.Tensor:
    """[world, 3 + S] state rows of every rank, on every rank."""
    import torch.distributed as dist

    row = _state_row(ops)
    table = torch.zeros((dist.get_world_size(), row.numel()),
                        dtype=torch.float64)
    table[dist.get_rank()] = row
    return channel.sum(table)


def verify_state(ops, channel: OpChannel) -> bool:
    """Rank 0, with the engine idle (on its loop thread: verify_engine):
    ask every rank for its state and compare. True when every rank
    sampled the same tokens and computed the same logits bit for bit at
    every step, and the ranks of each model group hold the same cache
    lengths. Also fills ops.last_state."""
    channel.publish(("checksum", (), {}))
    table = _state_table(ops, channel)
    mesh = ops.mesh
    n_model = mesh.n_model if mesh is not None else 1
    ok = bool((table[:, :3] == table[0, :3]).all())
    for d in range(table.shape[0] // n_model):
        grp = table[d * n_model:(d + 1) * n_model]
        ok &= bool((grp[:, 3:] == grp[0, 3:]).all())
    # every slot's length: model rank 0 of each data rank holds its slots
    ops.last_state = dict(tokens=int(table[0, 0]),
                          steps_equal=bool((table[:, 2] == table[0, 2]).all()),
                          lengths=table[::n_model, 3:].sum(0).tolist(), ok=ok)
    if not ok:
        log.error("grid state diverged: %r", table.tolist())
    return ok


def verify_engine(engine) -> bool:
    """verify_state for a leader's InferenceEngine, run on its loop thread
    so no op of the loop interleaves with the checksum's collectives."""
    return engine._call_on_loop(
        lambda: verify_state(engine.ops, engine.ops.channel))


def _broadcast_ops_factory(channel: OpChannel):
    """ops_factory for InferenceEngine on rank 0: publish, then execute."""
    from ..serve.ops import EngineOps

    class BroadcastOps(_Recorded, EngineOps):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.channel = channel

        def _publish(self, op, args, kwargs):
            channel.publish((op, args, kwargs))

        def step(self, tokens, slot_ids, active, n_valid=None,
                 collect_hidden=False, embd=None):
            if isinstance(embd, torch.Tensor):
                embd = embd.detach().cpu().numpy()
            self._publish("step",
                          (np.asarray(tokens), np.asarray(slot_ids),
                           np.asarray(active)),
                          {"n_valid": None if n_valid is None
                           else np.asarray(n_valid),
                           "collect_hidden": collect_hidden,
                           "embd": None if embd is None else np.asarray(embd)})
            return super().step(tokens, slot_ids, active, n_valid=n_valid,
                                collect_hidden=collect_hidden, embd=embd)

        def dloop(self, n_inner, active, reset=None):
            self._publish("dloop", (n_inner, np.asarray(active)),
                          {"reset": reset})
            return self._record(super().dloop(n_inner, active, reset=reset))

        def sample_first(self, logits, by_slot, prevs, seed, gstate=None):
            # every rank re-derives the logits with the replayed `step`, so
            # only the host-side sampling inputs travel
            self._publish("sample_first", (by_slot, prevs, int(seed)),
                          {"gstate": None if gstate is None
                           else np.asarray(gstate)})
            return self._record(super().sample_first(
                logits, by_slot, prevs, seed, gstate=gstate))

        def set_grammar_bank(self, mask, trans, row_off=None):
            self._publish("set_grammar_bank",
                          (np.asarray(mask), np.asarray(trans)),
                          {"row_off": row_off})
            super().set_grammar_bank(mask, trans, row_off=row_off)

        def trim(self, slot, n):
            self._publish("trim", (int(slot), int(n)), {})
            super().trim(slot, n)

        def seq_cp(self, src, dst):
            self._publish("seq_cp", (int(src), int(dst)), {})
            super().seq_cp(src, dst)

        def shift_compact(self, slot, n_keep, n_discard):
            self._publish("shift_compact",
                          (int(slot), int(n_keep), int(n_discard)), {})
            super().shift_compact(slot, n_keep, n_discard)

        def clear_all(self):
            self._publish("clear_all", (), {})
            super().clear_all()

        def shutdown(self):
            """Publish shutdown and collect the followers' kernel launch
            counts into FOLLOWER_LAUNCHES."""
            self._publish("shutdown", (), {})
            _collect_launches(channel)

    return BroadcastOps


def _collect_launches(channel: OpChannel) -> None:
    names = sorted(_launch_counts())
    mine = torch.zeros(len(names), dtype=torch.int64)  # rank 0 adds none
    if _is_leader():
        got = channel.sum(mine)
        for k, n in zip(names, got.tolist()):
            FOLLOWER_LAUNCHES[k] = FOLLOWER_LAUNCHES.get(k, 0) + int(n)
    else:
        counts = _launch_counts()
        channel.sum(torch.tensor([counts[k] for k in names],
                                 dtype=torch.int64))


def _is_leader() -> bool:
    import torch.distributed as dist

    return dist.get_rank() == 0


def _build_state(config: dict, with_cache: bool = True):
    """Model, mesh, cache and step functions, built the same way on every
    rank (the mesh's groups are created here, in the same order
    everywhere). The leader builds its cache inside InferenceEngine
    (with_cache=False)."""
    from ..kvcache.cache import default_layout, new_cache
    from ..model.loader import load_model
    from . import tp as _tp

    tp_size = config["tensor_parallel"]
    mesh = _tp.tp_mesh(tp_size, devices=config["devices"],
                       n_data=config["data_parallel"])
    lm = load_model(config["model_path"], device=mesh.device,
                    sharder=_tp.TPSharder(mesh) if tp_size > 1 else None)
    _tp.validate_tp(lm.cfg, lm.weights, tp_size)
    if not with_cache:
        return lm, mesh, None, None, None
    step_fn, dloop_fn = _tp.make_tp_functions(mesh, lm.weights, lm.cfg)
    cache = new_cache(
        lm.cfg.n_layer, config["n_parallel"], config["slot_ctx"],
        lm.cfg.n_kv_head, lm.cfg.head_dim, kind=config["cache_type"],
        # every rank picks the SAME layout (the engine's policy)
        layout=default_layout(config["cache_type"], lm.cfg.head_dim),
        device="meta")
    cache = _tp.shard_cache_tp(cache, mesh)
    return lm, mesh, cache, step_fn, dloop_fn


def start_leader(model_path: str, tensor_parallel: int, n_ctx: int = 2048,
                 n_parallel: int = 1, cache_type: str | None = None,
                 channel: OpChannel | None = None, data_parallel: int = 1,
                 devices=None, seed: int | None = None, **engine_kw):
    """Rank 0: publish the build config, then run the real engine with
    broadcasting ops. Returns the InferenceEngine (shutting it down stops
    the followers). seed: the sampler seed of every rank (None: fresh)."""
    import torch.distributed as dist

    from ..serve.engine import InferenceEngine
    from .sharding import attached_devices

    world = tensor_parallel * data_parallel
    devices = [str(d) for d in (devices if devices is not None
                                else attached_devices())][:world]
    if dist.get_rank() != 0:
        raise RuntimeError("the leader must be rank 0")
    channel = channel or OpChannel()
    config = {
        "model_path": model_path,
        "tensor_parallel": tensor_parallel,
        "data_parallel": data_parallel,
        "devices": devices,
        "n_parallel": n_parallel,
        "slot_ctx": max(n_ctx // n_parallel, 8),
        "cache_type": cache_type,
        "grp_attn_n": engine_kw.get("grp_attn_n", 1),
        "grp_attn_w": engine_kw.get("grp_attn_w", 512),
        "seed": (int(np.random.SeedSequence().entropy % (1 << 31))
                 if seed is None else int(seed)),
    }
    channel.publish(("init", config))
    lm, mesh, _, _, _ = _build_state(config, with_cache=False)
    eng = InferenceEngine(
        lm, n_ctx=n_ctx, n_parallel=n_parallel, cache_type=cache_type,
        mesh=mesh, ops_factory=_broadcast_ops_factory(channel), **engine_kw)
    # every rank seeds its sampler from this: identical streams
    eng._dev_seed = config["seed"]
    return eng


def serve_follower(channel: OpChannel | None = None) -> None:
    """A follower rank: build the same state, replay ops until shutdown."""
    import torch.distributed as dist

    if dist.get_rank() == 0:
        raise RuntimeError("rank 0 is the leader")
    from ..serve.ops import EngineOps

    class FollowerOps(_Recorded, EngineOps):
        def dloop(self, *a, **kw):
            return self._record(super().dloop(*a, **kw))

        def sample_first(self, *a, **kw):
            return self._record(super().sample_first(*a, **kw))

    channel = channel or OpChannel()
    op, config = channel.recv()
    if op != "init":
        raise RuntimeError(f"expected init, got {op}")
    lm, mesh, cache, step_fn, dloop_fn = _build_state(config)
    ops = FollowerOps(lm, lm.cfg, cache, step_fn, dloop_fn,
                      config["grp_attn_n"], config["grp_attn_w"], mesh)
    log.info("follower %d ready on %s", dist.get_rank(), mesh.device)
    n_ops = 0
    while True:
        name, args, kwargs = channel.recv()
        if name == "shutdown":
            _collect_launches(channel)
            break
        if name == "checksum":
            _state_table(ops, channel)
            continue
        if name == "dloop" and kwargs.get("reset") is not None:
            kwargs["reset"] = dict(kwargs["reset"], seed=config["seed"])
        if name == "sample_first":
            # the logits are this rank's own: the replayed `step` left them
            by_slot, prevs, _ = args
            ops.sample_first(ops._last_step_logits, by_slot, prevs,
                             config["seed"], gstate=kwargs.get("gstate"))
            n_ops += 1
            continue
        if name not in _REPLAYED:
            raise RuntimeError(f"unexpected op {name}")
        getattr(ops, name)(*args, **kwargs)
        n_ops += 1
    log.info("follower %d done after %d ops", dist.get_rank(), n_ops)


def follower_main(rank: int, world_size: int, init_method: str,
                  backend: str, devices, timeout_s: float = 600.0) -> None:
    """Entry point of a spawned follower process: join the group, serve
    until the leader's shutdown, leave the group."""
    import torch.distributed as dist

    initialize(init_method, world_size, rank, backend, devices, timeout_s)
    try:
        serve_follower(OpChannel())
    finally:
        dist.destroy_process_group()
