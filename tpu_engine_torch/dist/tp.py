"""Tensor and data parallelism over torch.distributed, one process a rank.

The counterpart of the JAX package's dist/tp.py. There one process runs
the forward inside shard_map over a ("data", "model") mesh of devices;
here each rank of the grid is a process of its own that runs the SAME
forward (model/llama.forward_step, decode_loop) on its own slices, with
the collectives written out (model/llama.tp_sum, tp_stack):

  wq/wk/wv, w_gate/w_up : rows (output features) split over "model"
  wo, w_down            : columns (input features) split over "model";
                          the ranks' f32 partial products are summed
  output (untied)       : vocab rows split; logits gathered after the head
  token_embd            : whole on every rank (the row gather stays local)
  KV cache              : kv heads split over "model", slots over "data"

So every kernel runs on every rank at the rank's shapes: qmm_nib4 and
qmm_i8 at N/p rows or K/p columns, the attention kernels at KH/p heads.

Data parallelism over "data" (BASELINE config 5's dp x tp grid): weights
are whole across "data" while the slots split, S/dp a rank. A decode
chunk runs on the rank's own slots; its tokens and sampler state are
reassembled on every rank. Prefill rows may target any slot, so each
rank runs only the rows whose slot it owns and one all_reduce over
"data" reassembles the batch's logits. dp engages when the mesh has a
"data" axis whose size divides the slot count.

Gathers are written as an all_reduce into a zeroed buffer in which each
rank fills its own part (exact: zeros add nothing), since torch.distributed
offers only all_reduce and broadcast for CUDA tensors on gloo. gloo lets
several ranks share one card (each rank a process on cuda:0); nccl needs
a card per rank and is refused on a repeated device.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import torch

from ..kvcache.cache import KVCache
from ..model.llama import decode_loop, forward_step
from ..model.weights import QTensor, qtensor_to
from ..sampling.device import DeviceSamplerState, param_rows, state_rows
from .sharding import make_mesh, make_sharder, shard_cache, shard_vec

log = logging.getLogger("tpu_engine.dist.tp")


@dataclass
class Mesh:
    """A grid of ranks, grid[d][m] the device of rank d * n_model + m, and
    this process's place in it. model_group / data_group are the
    torch.distributed groups of this rank's row and column (None where
    the axis has one rank)."""

    grid: list
    rank: int = 0
    model_group: object = field(default=None, repr=False)
    data_group: object = field(default=None, repr=False)

    @property
    def n_data(self) -> int:
        return len(self.grid)

    @property
    def n_model(self) -> int:
        return len(self.grid[0])

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    @property
    def device(self) -> torch.device:
        return torch.device(self.grid[self.data_rank][self.model_rank])


def dp_degree(mesh: Mesh, n_slots: int) -> int:
    """Effective data-parallel degree: the mesh's "data" axis when it
    divides the slot count (else slots stay whole on every rank)."""
    d = mesh.n_data
    return d if d > 1 and n_slots % d == 0 else 1


def default_backend(devices) -> str:
    """nccl when every rank has a CUDA device, else gloo."""
    return ("nccl" if all(torch.device(d).type == "cuda" for d in devices)
            else "gloo")


def check_backend(backend: str, devices) -> None:
    """Refuse a backend the grid's devices cannot run: nccl takes one
    card per rank, never the CPU or a card twice."""
    devs = [str(torch.device(d)) for d in devices]
    if backend == "nccl":
        if any(torch.device(d).type != "cuda" for d in devs):
            raise ValueError(f"backend nccl needs a CUDA device per rank: "
                             f"{devs}")
        rep = sorted({d for d in devs if devs.count(d) > 1})
        if rep:
            raise ValueError(f"backend nccl cannot run two ranks on one "
                             f"device ({', '.join(rep)} repeats); ask for "
                             "backend gloo to share a card")
    elif backend != "gloo":
        raise ValueError(f"unsupported torch.distributed backend {backend!r}")


def tp_mesh(n_model: int, devices=None, n_data: int = 1) -> Mesh:
    """The grid of n_data x n_model ranks over `devices` (default: every
    attached card) and this process's rank in it. Above one rank, every
    process must have called multihost.initialize (torch.distributed with
    world size n_data * n_model) and call this in the same order: it
    creates the row and column groups."""
    grid = make_mesh(n_data, n_model, devices)
    world = n_data * n_model
    if world == 1:
        return Mesh(grid)
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() != world:
        raise RuntimeError(
            f"tensor_parallel={n_model} x data_parallel={n_data} needs "
            f"torch.distributed initialized with {world} ranks "
            "(dist/multihost.initialize), one process a rank")
    check_backend(str(dist.get_backend()), [d for row in grid for d in row])
    mesh = Mesh(grid, rank=dist.get_rank())
    # every rank creates every group, in the same order
    if n_model > 1:
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == mesh.data_rank:
                mesh.model_group = g
    if n_data > 1:
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == mesh.model_rank:
                mesh.data_group = g
    return mesh


def TPSharder(mesh: Mesh):
    """Loader hook: load_model(path, sharder=TPSharder(mesh)) cuts every
    tensor to this rank's slice (dist/sharding.py) right after the rank
    extracts it whole on its own device; the whole tensor is freed before
    the next one is loaded:
    q/k/v and gate/up rows, wo/w_down columns, the untied output head's
    vocab rows, q/k/v biases; token_embd and norms whole."""
    return make_sharder(mesh.n_model, mesh.model_rank)


def validate_heads(cfg, p: int) -> None:
    """The head counts must split over p ranks."""
    if p > 1 and (cfg.n_head % p or cfg.n_kv_head % p):
        raise ValueError(
            f"tensor_parallel={p} requires n_head ({cfg.n_head}) and "
            f"n_kv_head ({cfg.n_kv_head}) divisible by it")


def validate_tp(cfg, weights: dict, p: int) -> None:
    """Fail fast when the model cannot run this TP degree (the JAX
    package's checks, on a rank's slices: a whole q|k|v, gate|up, wo or
    w_down under p > 1 means the model was loaded without TPSharder; a
    rank's q|k|v or gate|up fused again from its slices, stored fused or
    not, has 1/p of the rows and passes)."""
    if p <= 1:
        return  # dp-only serving: weights whole, nothing to split
    validate_heads(cfg, p)
    lw0 = weights["layers"][0]
    D = cfg.head_dim
    whole = {"wqkv": (cfg.n_head + 2 * cfg.n_kv_head) * D,
             "w_gateup": 2 * cfg.n_ff}
    if any(nm in lw0 and lw0[nm].shape[0] == n for nm, n in whole.items()):
        raise ValueError("TP expects unfused projections; load the model "
                         "with sharder=TPSharder(mesh)")
    for nm, k_full in (("wo", cfg.n_head * D), ("w_down", cfg.n_ff)):
        qt = lw0[nm]
        if k_full % p:
            raise ValueError(f"{nm} K={k_full} not divisible by p={p}")
        if qt.kind != "dense" and (k_full // p) % qt.group:
            raise ValueError(f"{nm} K/p={k_full // p} is not a multiple of "
                             f"its quantization group {qt.group}")
        shards = k_full // qt.shape[1]
        if shards != p:
            raise ValueError(
                f"{nm} has perm_shards={shards}, need {p}: load the "
                "model with sharder=TPSharder(mesh) so the kernel layout is "
                "chunked for TP")


def shard_cache_tp(cache: KVCache, mesh: Mesh) -> KVCache:
    """This rank's cache: KH/p kv heads, and S/dp slots under dp. A cache
    made on the "meta" device is allocated at the rank's shape only."""
    dp = dp_degree(mesh, cache.k.shape[1])
    return shard_cache(cache, mesh.n_model, mesh.model_rank, dp,
                       mesh.data_rank, device=mesh.device)


def place_aux_weights(weights: dict, mesh: Mesh) -> dict:
    """Every weight on this rank's device, with q/k/v biases cut to the
    rank's heads where they are still whole (TPSharder cuts them at load;
    norms stay whole). Tensors already in place are not copied."""
    dev, p, r = mesh.device, mesh.n_model, mesh.model_rank

    def put(x):
        return qtensor_to(x, dev) if isinstance(x, QTensor) else x.to(dev)

    out = {k: put(v) for k, v in weights.items()
           if k not in ("layers", "output")}
    out["output"] = (out["token_embd"]
                     if weights["output"] is weights["token_embd"]
                     else put(weights["output"]))
    layers = []
    for lw in weights["layers"]:
        nl = {k: put(v) for k, v in lw.items()}
        for b, w in (("bq", "wq"), ("bk", "wk"), ("bv", "wv")):
            if b in nl and w in nl and nl[b].shape[0] != nl[w].shape[0]:
                nl[b] = shard_vec(nl[b], b, p, r)
        if "bqkv" in nl and nl["bqkv"].shape[0] != nl["wqkv"].shape[0]:
            raise ValueError("bqkv is whole while wqkv is a rank's slice: "
                             "load the model with sharder=TPSharder(mesh)")
        layers.append(nl)
    out["layers"] = layers
    return out


def _rows_to_all(x: torch.Tensor, lo: int, n_all: int, group) -> torch.Tensor:
    """Rows [lo, lo + len(x)) from each data rank -> all n_all rows on
    every rank (all_reduce into zeros; each row has one writer)."""
    import torch.distributed as dist

    buf = x.new_zeros((n_all, *x.shape[1:]))
    buf[lo:lo + x.shape[0]] = x
    dist.all_reduce(buf, group=group)
    return buf


def make_tp_functions(mesh: Mesh, weights: dict, cfg):
    """(forward_step, decode_loop) drop-ins for this rank of the mesh.

    Signatures match model.llama.forward_step / decode_loop, with slot ids
    and per-slot arrays over every slot of the engine, so the serving
    engine swaps them in unchanged (serve/engine.py)."""
    validate_tp(cfg, weights, mesh.n_model)
    group, dgroup = mesh.model_group, mesh.data_group

    def fwd(weights, cache, tokens, slot_ids, active, cfg_, ga_n=1, ga_w=0,
            n_valid=None, collect_hidden=False, embd=None, rot_cache=False):
        kw = dict(ga_n=ga_n, ga_w=ga_w, collect_hidden=collect_hidden,
                  rot_cache=rot_cache, tp_group=group)
        if cache.slot_shards <= 1:
            return forward_step(weights, cache, tokens, slot_ids, active, cfg,
                                n_valid=n_valid, embd=embd, **kw)
        # the rows whose slot this rank holds (slot s lives on data rank
        # s // S_local); every rank of a model group owns the same rows
        B, Tc = tokens.shape
        s_local = cache.n_slots
        base = mesh.data_rank * s_local
        rows = [b for b, s in enumerate(slot_ids.tolist())
                if base <= s < base + s_local]
        dev = tokens.device
        logits = torch.zeros((B, cfg.n_vocab), dtype=torch.float32, device=dev)
        pooled = None
        if collect_hidden:
            E = cfg.n_embd
            pooled = torch.zeros((B, Tc, E) if collect_hidden == "all"
                                 else (B, E), dtype=torch.float32, device=dev)
        if rows:
            idx = torch.tensor(rows, dtype=torch.long, device=dev)
            lg, cache, pl = forward_step(
                weights, cache, tokens[idx], slot_ids[idx] - base,
                active[idx], cfg,
                n_valid=None if n_valid is None else n_valid[idx],
                embd=None if embd is None else embd[idx], **kw)
            logits[idx] = lg
            if pooled is not None:
                pooled[idx] = pl
        import torch.distributed as dist

        # reassemble the batch: each row comes from exactly one data rank
        dist.all_reduce(logits, group=dgroup)
        if pooled is not None:
            dist.all_reduce(pooled, group=dgroup)
        return logits, cache, pooled

    def dloop(weights, cache, tokens, active, cfg_, samp_params, samp_state,
              n_inner, ga_n=1, ga_w=0, rot_cache=False, gbank=None):
        kw = dict(ga_n=ga_n, ga_w=ga_w, rot_cache=rot_cache, gbank=gbank,
                  tp_group=group)
        if cache.slot_shards <= 1:
            return decode_loop(weights, cache, tokens, active, cfg,
                               samp_params, samp_state, n_inner, **kw)
        # batched decode is data-parallel: this rank's slots, their
        # sampler rows (draws of every slot, sampling/device.row_span)
        S = tokens.shape[0]
        lo = mesh.data_rank * cache.n_slots
        hi = lo + cache.n_slots
        toks, _, cache, st = decode_loop(
            weights, cache, tokens[lo:hi], active[lo:hi], cfg,
            param_rows(samp_params, lo, hi), state_rows(samp_state, lo, hi),
            n_inner, **kw)
        # every slot's tokens and sampler rows on every rank, one all_reduce
        n = toks.shape[1]
        packed = torch.cat([toks, st.ring, st.gstate[:, None]], dim=1)
        full = _rows_to_all(packed, lo, S, dgroup)
        toks = full[:, :n]
        state = DeviceSamplerState(ring=full[:, n:-1], gen=st.gen,
                                   gstate=full[:, -1])
        return toks, toks[:, -1], cache, state

    return fwd, dloop
