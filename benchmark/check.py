"""How `correct` is decided: the served tokens against the plain reference.

Once the window has closed and the program's state is freed, two samples
drawn from the seed of the requests that served content (finished, or
cut by the window's close: a streamed reply's tokens up to there), each
with the one that served the most tokens always in it, go through the
reference of the cell's configuration (models/<reference>.py, float32,
TF32 off), prompt and served tokens together, in one pass: the greedy
requests, and the requests that sample.

Each served token is judged by the rule its request asked for (its
sampling fields over the chat endpoint's defaults): the repeat penalty
over the last tokens, then the candidates the sampler may draw from, the
top_k best, of those the first whose probability before them stays under
top_p, and of those the ones within min_p of the best (a greedy request:
the best alone). Temperature and the draw choose among the candidates,
so they are not judged token by token. The number read for a token is its
admission gap: the least rise of its logit in the reference that would
make it a candidate, 0 where it is one. For a greedy token that is the
gap of its logit below the reference's best. `max_logit_gap` is the
widest over the greedy sample, `sampled_logit_gap` over the sampled one
(where the cell's traffic samples).

Further numbers compared: requests that failed (an answer that never
came), finished replies whose token count differs from the count the
server reports, and weights the reference drew differently from the
served ones.

checks/<workload>.json holds each limit and the readings it was set from.

The reference is the configuration's model module, models/<reference>.py
(gguf_file.model_module), the one that also gives the GGUF's tensors
and metadata (tensor_table in weights.py, gguf_metadata in gguf_file.py).
It imports nothing of the program and defines

    Reference(cfg, raw, precision="f32")

over raw = {name: (shape, ggml type, flat uint8 bytes)}, every tensor of
weights.draw_tensors drawn anew from the seed on the device (the same
bytes the program was served, decoded by the module itself), with
`.raw`, and `.logits(seqs, spans)`: per token sequence, float32 logits
[hi - lo, V] at positions lo..hi-1 of its (lo, hi) span, from one full
forward pass in float32 with TF32 off. precision "fp8" is the control:
the same model with every matrix product's operands rounded to float8.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .gguf_file import model_module, text_to_ids
from .traffic import prompt_ids
from .weights import draw_tensors

# What a chat request that names no sampling field gets (the OpenAI chat
# endpoint's defaults, as cortex's chat_completion_request.h sets them).
API_DEFAULTS = {"temperature": 0.8, "top_k": 40, "top_p": 0.95, "min_p": 0.05,
                "repeat_penalty": 1.1, "repeat_last_n": 64}
SEARCH_STEPS = 48  # bisections of an admission gap


def rule(fields: dict) -> dict:
    """The sampling rule a request asked for; a greedy one keeps the best
    token alone."""
    r = {k: float(fields.get(k, v)) for k, v in API_DEFAULTS.items()}
    if r["temperature"] <= 0:
        r.update(top_k=1, top_p=1.0, min_p=0.0)
    return r


def sample(records: list, seed: int, n: int, greedy: bool = True) -> list:
    """Up to n requests of the kind (greedy or sampling) that served
    content and did not fail: the one that served the most tokens, and the
    rest drawn from the seed."""
    served = [r for r in records if bool(r.get("greedy")) == greedy
              and "error" not in r and r.get("text")]
    if not served or n <= 0:
        return []
    served.sort(key=lambda r: (r["client"], r["k"]))
    longest = max(range(len(served)), key=lambda i: len(served[i]["text"]))
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 0x636865636B,
                                 int(greedy)])
    rest = [i for i in rng.permutation(len(served)).tolist() if i != longest]
    return [served[i] for i in [longest] + rest[:n - 1]]


def reference(cfg: dict, seed: int, device):
    """The configuration's reference over weights drawn anew from the seed,
    and the tensors' checksums."""
    mod = model_module(cfg)
    raw, sums = {}, []
    for name, shape, ty, data in draw_tensors(cfg, seed, device):
        raw[name] = (shape, ty, data)
        sums.append(data.to(torch.int64).sum())
    return mod.Reference(cfg, raw), torch.stack(sums).tolist()


def sequences(cfg: dict, recs: list) -> tuple[list, list, list]:
    """(full token sequences, served-logit spans, served ids) of records."""
    seqs, spans, served = [], [], []
    for r in recs:
        p = prompt_ids(cfg, r["messages"])
        s = text_to_ids(r["text"], cfg["vocab_size"])
        seqs.append(p + s)
        spans.append((len(p) - 1, len(p) - 1 + len(s)))
        served.append(s)
    return seqs, spans, served


def penalized(logits: torch.Tensor, seq: list, lo: int, r: dict) -> torch.Tensor:
    """logits [N, V] at positions lo..lo+N-1 of seq, with the repeat
    penalty over the last repeat_last_n tokens up to each position: a
    positive logit divided by it, a negative one multiplied."""
    n, rp = int(r["repeat_last_n"]), r["repeat_penalty"]
    if rp == 1.0 or n <= 0:
        return logits
    dev = logits.device
    s = torch.as_tensor(seq, dtype=torch.long, device=dev)
    N = logits.shape[0]
    idx = (lo + 1 - n + torch.arange(N, device=dev)[:, None]
           + torch.arange(n, device=dev)[None, :])
    win = s[idx.clamp_min(0)]
    # a position before the sequence's start repeats the newest token
    win = torch.where(idx >= 0, win, win[:, -1:])
    g = logits.gather(1, win)
    return logits.scatter(1, win, torch.where(g <= 0, g * rp, g / rp))


def _admitted(top: torch.Tensor, zt: torch.Tensor, r: dict, k: int) -> torch.Tensor:
    """Whether a token of logit zt is one of the top_k (k) candidates beside
    the others' best logits top [N, >= k - 1] (descending)."""
    m = torch.maximum(top[:, 0], zt)
    others = top[:, :k - 1]
    e = torch.exp(others - m[:, None])
    above = others > zt[:, None]
    before = (e * above).sum(1) / (e.sum(1) + torch.exp(zt - m))
    floor = m + (math.log(r["min_p"]) if r["min_p"] > 0 else -math.inf)
    return ((top > zt[:, None]).sum(1) < k) & (before < r["top_p"]) & (zt >= floor)


def admission_gaps(logits: torch.Tensor, ids, r: dict) -> torch.Tensor:
    """Per row of logits [N, V] (penalized), the least rise of the logit of
    ids[row] that makes it a candidate under rule r; 0 where it is one."""
    z = logits.to(torch.float64)
    tok = torch.as_tensor(ids, dtype=torch.long, device=z.device)[:, None]
    zt = z.gather(1, tok)[:, 0]
    V = z.shape[1]
    k = int(r["top_k"]) if 0 < r["top_k"] < V else V
    top = torch.topk(z.scatter(1, tok, -math.inf), min(k, V - 1), dim=-1).values
    lo = torch.zeros_like(zt)
    hi = (top[:, 0] - zt).clamp_min(0.0)  # level with the best: admitted
    done = _admitted(top, zt, r, k)
    hi = torch.where(done, lo, hi)
    for _ in range(SEARCH_STEPS):
        mid = (lo + hi) / 2
        ok = _admitted(top, zt + mid, r, k)
        hi, lo = torch.where(ok, mid, hi), torch.where(ok, lo, mid)
    return hi.to(torch.float32)


def drawn(logits: torch.Tensor, r: dict, gen: torch.Generator) -> torch.Tensor:
    """The token a sampler with rule r draws from each row of logits
    (penalized): the best for a greedy rule, else a Gumbel draw at the
    temperature among the candidates."""
    if r["top_k"] == 1:
        return logits.argmax(-1)
    k = int(r["top_k"]) if 0 < r["top_k"] < logits.shape[1] else logits.shape[1]
    v, idx = torch.topk(logits, k, dim=-1)
    pr = torch.softmax(v, dim=-1)
    keep = ((torch.cumsum(pr, -1) - pr) < r["top_p"]) & (pr >= pr[:, :1] * r["min_p"])
    keep[:, 0] = True
    u = torch.rand(v.shape, generator=gen, device=v.device).clamp_min(1e-30)
    score = torch.where(keep, v / r["temperature"] - torch.log(-torch.log(u)),
                        -math.inf)
    return idx.gather(1, score.argmax(-1, keepdim=True))[:, 0]


def widest_gap(ref, cfg: dict, recs: list, low=None, seed: int = 0) -> tuple:
    """(widest admission gap of the served tokens, of the tokens the
    reference `low` draws at the same positions or None, tokens read)."""
    if not recs:
        return 0.0, None, 0
    seqs, spans, served = sequences(cfg, recs)
    logits = ref.logits(seqs, spans)
    rules = [rule(r.get("fields") or {}) for r in recs]
    gap = max(float(admission_gaps(penalized(lg, s, sp[0], ru), ids, ru).max())
              for lg, s, sp, ids, ru in zip(logits, seqs, spans, served, rules))
    low_gap = None
    if low is not None:
        gen = torch.Generator(device=logits[0].device)
        gen.manual_seed(int(seed) & (2**63 - 1))
        low_gap = 0.0
        for lg, lc, s, sp, ru in zip(logits, low.logits(seqs, spans), seqs,
                                     spans, rules):
            picks = drawn(penalized(lc, s, sp[0], ru), ru, gen)
            low_gap = max(low_gap, float(admission_gaps(
                penalized(lg, s, sp[0], ru), picks, ru).max()))
    return gap, low_gap, sum(len(x) for x in served)


def run(cfg: dict, check: dict, records: list, seed: int, device,
        sums_served: list | None, control: bool = False) -> list:
    """[(name, value, limit)] of every number compared; correct when each
    value <= its limit. control: also read the control on the same samples
    (the reference in float8, models' precision "fp8", in the program's
    place): the admission gap, in the float32 reference, of the token it
    draws at each served position (control.py; never in a benchmark run)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failed = sum(1 for r in records if "error" in r)
    mismatched = 0
    for r in records:
        if r.get("done") is None or "error" in r:
            continue
        n = r.get("timings", {}).get("predicted_n")
        if n is not None and n != len(r.get("text", "")):
            mismatched += 1
    kinds = [("max_logit_gap", sample(records, seed, int(check["sample"])))]
    if "sampled_logit_gap" in check:
        kinds.append(("sampled_logit_gap", sample(
            records, seed, int(check["sampled_sample"]), greedy=False)))
    out = [("failed_requests", failed, 0),
           ("token_count_mismatches", mismatched, 0)]
    ref, sums = reference(cfg, seed, device)
    if sums_served is not None:
        out.append(("weights_redrawn_apart",
                    sum(a != b for a, b in zip(sums, sums_served)), 0))
    out.append(("nothing_checked", sum(1 for _, recs in kinds if not recs), 0))
    low = type(ref)(cfg, ref.raw, "fp8") if control else None
    for name, recs in kinds:
        if not recs:
            continue
        gap, low_gap, n_tok = widest_gap(ref, cfg, recs, low, seed)
        out.append((name, gap, float(check[name])))
        if control:
            out.append(("control_" + name, low_gap, float(check[name])))
            out.append((name + "_tokens", n_tok, None))
    return out
