"""Device-side sampling chain for multi-token decode loops (PyTorch port).

The common subset of the host chain (chain.py), vectorized over slots so
the engine samples N tokens per host round-trip:

    grammar mask (byte-DFA bank, see GrammarBank)
    -> penalties (repeat/freq/presence over a last-n ring)
    -> top_k -> top_p -> min_p -> temperature -> Gumbel draw (or greedy)

Same semantics as the JAX package's sampling/device.py. Randomness comes
from one torch.Generator on the sampling device, seeded per engine; JAX's
PRNG keys and torch's generator give different numbers, so draws match
the JAX package in distribution only (greedy tokens match exactly).
The Gumbel draw is one per (slot, token id), where the JAX package draws
one per sorted candidate position: the law is the same, but a small
change of the logits that reorders two candidates then moves each
token's score by that change alone, instead of handing it another
candidate's noise. Under data parallelism (dist/tp.py) a rank samples
only its own slots, but draws the noise of every slot from the same
seeded generator and keeps its rows (row_span), as the JAX package keeps
one key per slot: a DP run samples what the one-rank run samples, and
where a rank's kernels round its logits apart from one rank's (a
product over S/dp rows), the two part only at a near-tie of scores.
Requests needing mirostat, typical_p, dynatemp, logit_bias, n_probs or a
fixed seed stay on the host chain.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .chain import SamplingParams

DEVICE_TOP_K = 64  # top-k capture width on device
RING_LEN = 64  # penalty window (reference default repeat_last_n=64)


def device_compatible(p: SamplingParams, eog_ok: bool = True) -> bool:
    """Can this request's sampling run fully on the device?"""
    return (
        p.n_probs == 0
        and p.mirostat == 0
        and p.typical_p >= 1.0
        and p.dynatemp_range == 0.0
        and not p.logit_bias
        and (not p.ignore_eos or eog_ok)
        and (p.seed is None or p.temperature <= 0)
        and (p.top_k <= DEVICE_TOP_K or p.temperature <= 0)
        and p.repeat_last_n <= RING_LEN
    )


@dataclass
class DeviceSamplerState:
    """Per-slot sampler state living on the device across inner steps."""

    ring: torch.Tensor  # [S, RING_LEN] int32, -1 = empty (penalty window)
    gen: torch.Generator  # draws for every slot (one stream per engine)
    gstate: torch.Tensor  # [S] int32 grammar-DFA bank row (0 = unconstrained)
    # (first row, all rows): these S rows are a data-parallel rank's part
    # of the engine's slots; draws are made for all rows. None: every slot
    row_span: tuple[int, int] | None = None


def state_rows(state: DeviceSamplerState, lo: int,
               hi: int) -> DeviceSamplerState:
    """Rows [lo, hi) of a sampler state over every slot (one DP rank's
    slots); the generator is shared, so draws stay those of every slot."""
    return DeviceSamplerState(ring=state.ring[lo:hi], gen=state.gen,
                              gstate=state.gstate[lo:hi],
                              row_span=(lo, state.ring.shape[0]))


@dataclass
class GrammarBank:
    """Token-level grammar tables shared by all slots, fixed shape. Row 0
    is the pass-through state; mask[s, v]: token v legal from state s;
    trans[s, v]: next state."""

    mask: torch.Tensor  # [NS, V] bool
    trans: torch.Tensor  # [NS, V] int32


def passthrough_bank(n_vocab: int, n_states: int = 1, device=None) -> GrammarBank:
    return GrammarBank(
        mask=torch.ones((n_states, n_vocab), dtype=torch.bool, device=device),
        trans=torch.zeros((n_states, n_vocab), dtype=torch.int32, device=device))


def expand_token_tables(dfa, tok, n_cols: int | None = None, device=None):
    """Token-level tables (mask [ns, V], trans [ns, V]) from a ByteDFA: every
    token's piece bytes fold through the byte transitions, all states and
    tokens at once on `device`."""
    from ..grammar.dfa import eog_token_ids, piece_tables

    pieces, lens = piece_tables(tok)
    V = pieces.shape[0]
    ns = dfa.n_states
    dead = ns - 1
    bt = torch.as_tensor(np.asarray(dfa.trans), dtype=torch.long, device=device)
    pc = torch.as_tensor(np.asarray(pieces), dtype=torch.long, device=device)
    ln = torch.as_tensor(np.asarray(lens), dtype=torch.long, device=device)
    cur = torch.arange(ns, device=device)[:, None].expand(ns, V).clone()
    for j in range(pieces.shape[1]):
        step = bt[cur, pc[None, :, j].expand(ns, V)]
        cur = torch.where(j < ln[None, :], step, cur)
    mask = (cur != dead) & (ln[None, :] > 0)
    trans = torch.where(mask, cur, dead).to(torch.int32)
    eog = [t for t in eog_token_ids(tok) if t < V]
    if eog:
        cols = torch.as_tensor(eog, dtype=torch.long, device=device)
        acc = torch.as_tensor(np.asarray(dfa.accept), dtype=torch.bool,
                              device=device)
        mask[:, cols] = acc[:, None].expand(ns, len(eog))
        trans[:, cols] = torch.arange(ns, dtype=torch.int32,
                                      device=device)[:, None].expand(ns, len(eog))
    n = n_cols if n_cols is not None else V
    if n > V:  # logits padded beyond the vocab
        mask = torch.cat([mask, torch.zeros((ns, n - V), dtype=torch.bool,
                                            device=device)], dim=1)
        trans = torch.cat([trans, torch.full((ns, n - V), dfa.dead,
                                             dtype=torch.int32, device=device)],
                          dim=1)
    return mask, trans


@dataclass
class DeviceSamplerParams:
    """Per-slot sampling knobs as device tensors [S]."""

    temp: torch.Tensor
    top_k: torch.Tensor
    top_p: torch.Tensor
    min_p: torch.Tensor
    repeat_penalty: torch.Tensor
    freq_penalty: torch.Tensor
    presence_penalty: torch.Tensor
    penalty_last_n: torch.Tensor
    ignore_eos: torch.Tensor | None = None  # [S] bool: ban the EOG columns
    all_greedy: bool = False  # every slot greedy -> penalized argmax only
    eog_cols: tuple = ()  # the tokenizer's EOG token ids


def param_rows(params: DeviceSamplerParams, lo: int,
               hi: int) -> DeviceSamplerParams:
    """Rows [lo, hi) of per-slot params. all_greedy stays that of every
    slot, so a rank draws (or skips drawing) exactly as one rank would."""
    def cut(t):
        return None if t is None else t[lo:hi]

    return DeviceSamplerParams(
        temp=cut(params.temp), top_k=cut(params.top_k),
        top_p=cut(params.top_p), min_p=cut(params.min_p),
        repeat_penalty=cut(params.repeat_penalty),
        freq_penalty=cut(params.freq_penalty),
        presence_penalty=cut(params.presence_penalty),
        penalty_last_n=cut(params.penalty_last_n),
        ignore_eos=cut(params.ignore_eos), all_greedy=params.all_greedy,
        eog_cols=params.eog_cols)


def new_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def new_state(n_slots: int, seed: int = 0, gstate=None,
              device=None) -> DeviceSamplerState:
    if device is None:
        raise ValueError("new_state needs an explicit device")
    return DeviceSamplerState(
        ring=torch.full((n_slots, RING_LEN), -1, dtype=torch.int32,
                        device=device),
        gen=new_generator(seed, device),
        gstate=(torch.zeros((n_slots,), dtype=torch.int32, device=device)
                if gstate is None else
                torch.as_tensor(np.asarray(gstate), dtype=torch.int32,
                                device=device)))


def params_from_host(slot_params: list[SamplingParams | None],
                     eog_ids: tuple = (), device=None) -> DeviceSamplerParams:
    """Pack per-slot SamplingParams into device tensors (idle slots get
    defaults)."""
    if device is None:
        raise ValueError("params_from_host needs an explicit device")

    def arr(get, default, dtype):
        return torch.as_tensor(
            np.asarray([get(p) if p is not None else default
                        for p in slot_params], dtype), device=device)

    return DeviceSamplerParams(
        temp=arr(lambda p: p.temperature, 0.0, np.float32),
        top_k=arr(lambda p: p.top_k if p.top_k > 0 else DEVICE_TOP_K,
                  DEVICE_TOP_K, np.int32),
        top_p=arr(lambda p: p.top_p, 1.0, np.float32),
        min_p=arr(lambda p: p.min_p, 0.0, np.float32),
        repeat_penalty=arr(lambda p: p.repeat_penalty, 1.0, np.float32),
        freq_penalty=arr(lambda p: p.frequency_penalty, 0.0, np.float32),
        presence_penalty=arr(lambda p: p.presence_penalty, 0.0, np.float32),
        penalty_last_n=arr(lambda p: p.repeat_last_n, 0, np.int32),
        ignore_eos=arr(lambda p: p.ignore_eos, False, np.bool_),
        all_greedy=all(p is None or p.temperature <= 0 for p in slot_params),
        eog_cols=tuple(eog_ids),
    )


def ring_from_tokens(tokens: list[list[int]], n_slots: int,
                     device=None) -> torch.Tensor:
    ring = np.full((n_slots, RING_LEN), -1, np.int32)
    for s, toks in enumerate(tokens[:n_slots]):
        tail = toks[-RING_LEN:]
        if tail:
            ring[s, -len(tail):] = tail
    return torch.as_tensor(ring, device=device)


def filtered_logits(logits: torch.Tensor, params: DeviceSamplerParams,
                    state: DeviceSamplerState, gbank: GrammarBank | None = None):
    """Grammar mask, ignore_eos ban and penalties: the [S, V] logits the
    candidate filters start from."""
    S, V = logits.shape
    ring = state.ring
    allow = None
    if gbank is not None:
        allow = gbank.mask[state.gstate.long()]
        logits = torch.where(allow, logits, -torch.inf)
    if params.eog_cols and params.ignore_eos is not None:
        cols = torch.as_tensor(params.eog_cols, dtype=torch.long,
                               device=logits.device)
        ban = params.ignore_eos[:, None]
        if allow is not None:
            # a finite grammar at an accept state with only EOG legal must
            # keep it, or the row would have no legal token at all
            eogm = torch.zeros((V,), dtype=torch.bool, device=logits.device)
            eogm[cols] = True
            ban = ban & torch.any(allow & ~eogm[None, :], dim=-1)[:, None]
        logits = logits.clone()
        logits[:, cols] = torch.where(ban, -torch.inf, logits[:, cols])

    # penalties over the ring window (ring-local gather/scatter, as JAX)
    pos = torch.arange(RING_LEN, device=logits.device)[None, :]
    in_window = (ring >= 0) & (pos >= (RING_LEN - params.penalty_last_n[:, None]))
    safe = torch.clamp(ring, min=0).long()
    same = (safe[:, :, None] == safe[:, None, :]) & in_window[:, None, :]
    counts = same.to(torch.float32).sum(dim=-1)
    g = torch.gather(logits, 1, safe)
    rp = params.repeat_penalty[:, None]
    pen = torch.where(g <= 0, g * rp, g / rp)
    pen = pen - counts * params.freq_penalty[:, None]
    pen = pen - params.presence_penalty[:, None]
    pen = torch.where(counts > 0, pen, g)
    return logits.scatter(1, safe, pen)


def candidates(logits: torch.Tensor, params: DeviceSamplerParams):
    """top_k capture, then top_p / min_p over the sorted candidates.
    Returns (v [S, DK] with dropped entries at -inf, idx [S, DK])."""
    v, idx = torch.topk(logits, DEVICE_TOP_K, dim=-1)
    dk_pos = torch.arange(DEVICE_TOP_K, device=logits.device)[None, :]
    k_eff = torch.clamp(params.top_k, 1, DEVICE_TOP_K)[:, None]
    v = torch.where(dk_pos < k_eff, v, -torch.inf)
    pr = torch.softmax(v, dim=-1)
    cum = torch.cumsum(pr, dim=-1)
    keep = ((cum - pr) < params.top_p[:, None]) & (
        pr >= pr[:, :1] * params.min_p[:, None])
    keep[:, 0] = True  # min_keep = 1
    return torch.where(keep, v, -torch.inf), idx


def gumbel_noise(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws -log(-log(u)), u ~ U(0, 1) from gen."""
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


def sample_step(logits: torch.Tensor, params: DeviceSamplerParams,
                state: DeviceSamplerState, gbank: GrammarBank | None = None):
    """One sampling step for all slots: (tokens [S] int32, new state). The
    state's generator advances in place; ring and gstate are new tensors."""
    logits = filtered_logits(logits, params, state, gbank)

    def advance(tokens):
        ring = torch.cat([state.ring[:, 1:], tokens[:, None]], dim=1)
        gs = (state.gstate if gbank is None
              else gbank.trans[state.gstate.long(), tokens.long()])
        return DeviceSamplerState(ring=ring, gen=state.gen, gstate=gs,
                                  row_span=state.row_span)

    if params.all_greedy:
        tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return tokens, advance(tokens)

    v, idx = candidates(logits, params)
    greedy = params.temp <= 0.0
    scaled = v / torch.clamp(params.temp, min=1e-6)[:, None]
    S, V = logits.shape
    if state.row_span is None:  # a draw per token id
        noise = gumbel_noise((S, V), state.gen, v.device)
    else:  # every slot's draws, this rank's rows kept
        lo, n_all = state.row_span
        noise = gumbel_noise((n_all, V), state.gen, v.device)[lo:lo + S]
    score = torch.where(greedy[:, None], v,
                        scaled + torch.gather(noise, 1, idx))
    choice = torch.argmax(score, dim=-1)
    tokens = torch.gather(idx, 1, choice[:, None])[:, 0].to(torch.int32)
    return tokens, advance(tokens)
