"""The general traffic generator: a traffic/<name>.json file of parameters
and a seed in, a schedule of requests out.

Every size and gap is drawn block-stratified: each block of BLOCK draws
holds the BLOCK quantiles (k + 0.5) / BLOCK of the distribution, in an
order shuffled by the seed. So every seed, and every whole number of
blocks of one seed, gives the same set of sizes and gaps in another
order, and the seed changes which tokens are sent and in what order, not
how much work they are. Token ids are uniform over the content range.

A request is sent as text of the synthetic tokenizer (gguf_file): the
prompt of a user message of ids u is ids_to_text(u), and the server's
template turns a conversation into [bos] + ids with a one-token marker
before each system message and after each turn (markers()).

Parameters (traffic/*.json):
  loop: "closed" (clients that each wait for their reply) or "open"
      (Poisson arrivals at rate_per_s, sent whether or not earlier
      requests finished)
  clients: closed loop's client count; stagger_s: their start spread
  rate_per_s: open loop's arrival rate
  stream: SSE streaming or one JSON reply
  prompt_tokens / max_tokens / user_tokens: {"dist": "uniform" |
      "loguniform", "lo": int, "hi": int}
  sessions (closed loop only): {"system_prompts": n, "system_tokens": n,
      "turns": [lo, hi], "max_history": n} multi-turn conversations
  greedy_every: every n-th request (or session) is greedy (temperature
      0, no repeat penalty), the others sample with `sampling`
  sampling: request fields of the sampled requests
  load: the /loadmodel fields of the cell (n_parallel, ctx_len, ...)
"""

from __future__ import annotations

import math

import numpy as np

from .gguf_file import add_bos, ids_to_text

BLOCK = 16
GREEDY = {"temperature": 0.0, "repeat_penalty": 1.0}


def quantile(dist: dict, u: float) -> int:
    lo, hi = dist["lo"], dist["hi"]
    if dist["dist"] == "uniform":
        return int(math.floor(lo + u * (hi - lo + 1)))
    if dist["dist"] == "loguniform":
        return int(round(math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))))
    raise ValueError(f"unknown distribution {dist['dist']!r}")


def stratified(rng: np.random.Generator, n: int, qf) -> list:
    """n draws, BLOCK quantiles of qf per block, each block shuffled."""
    out: list = []
    while len(out) < n:
        block = [qf((k + 0.5) / BLOCK) for k in range(BLOCK)]
        out += [block[i] for i in rng.permutation(BLOCK)]
    return out[:n]


def markers(cfg: dict) -> dict:
    """Token ids of the template's system and assistant markers, and the
    content id range [lo, hi) (clear of unk, bos, eos and the markers)."""
    special = {cfg["bos_token_id"], cfg["eos_token_id"]}
    free = [i for i in range(8) if i not in special]
    unk, sys_id, ai_id = free[0], free[1], free[2]
    hi = min([b for b in special if b > 8] + [cfg["vocab_size"]])
    return {"unk": unk, "system": sys_id, "ai": ai_id,
            "lo": max(unk, sys_id, ai_id) + 1, "hi": hi}


def load_body(cfg: dict, traffic: dict) -> dict:
    """The template fields /loadmodel takes, with the cell's load fields."""
    m = markers(cfg)
    chars = ids_to_text([m["system"], m["ai"]], cfg["vocab_size"])
    body = {"user_prompt": "", "system_prompt": chars[0], "ai_prompt": chars[1],
            "pre_prompt": ""}
    body.update(traffic["load"])
    return body


def prompt_ids(cfg: dict, messages: list) -> list:
    """The ids the server's template makes of `messages` [(role, ids)]."""
    m = markers(cfg)
    ids = [cfg["bos_token_id"]] if add_bos(cfg) else []
    for role, toks in messages:
        if role == "system":
            ids.append(m["system"])
        elif role == "assistant":
            ids.append(m["ai"])
        ids += toks
    return ids + [m["ai"]]


def _sampling(traffic: dict, k: int) -> tuple[bool, dict]:
    every = traffic.get("greedy_every", 1)
    greedy = every > 0 and k % every == 0
    return greedy, dict(GREEDY if greedy else traffic.get("sampling", {}))


def build(cfg: dict, traffic: dict, seed: int, n_requests: int = 4096) -> dict:
    """The schedule of one run: {"loop", "stream", ...} with
      open loop:   "requests": [{"due": s after start, "messages", ...}]
      closed loop: "clients": [[request or session, ...] per client]
    Each request: {"messages": [(role, ids)], "max_tokens", "fields",
    "greedy"}; a session: {"system": ids, "turns": [{"user": ids,
    "max_tokens"}], "fields", "greedy"} (the answers are the served ones)."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 0x7261666669])
    m = markers(cfg)
    lo, hi = m["lo"], m["hi"]

    def tokens(n: int) -> list:
        return rng.integers(lo, hi, n).tolist()

    out = {"loop": traffic["loop"], "stream": bool(traffic["stream"])}
    if "sessions" in traffic:
        s = traffic["sessions"]
        systems = [tokens(s["system_tokens"]) for _ in range(s["system_prompts"])]
        n_sess = n_requests // 4
        turns = stratified(rng, n_sess,
                           lambda u: quantile({"dist": "uniform", "lo": s["turns"][0],
                                               "hi": s["turns"][1]}, u))
        n_turns = sum(turns)
        users = stratified(rng, n_turns, lambda u: quantile(traffic["user_tokens"], u))
        outs = stratified(rng, n_turns, lambda u: quantile(traffic["max_tokens"], u))
        which = stratified(rng, n_sess, lambda u: int(u * s["system_prompts"]))
        sessions, t = [], 0
        for k in range(n_sess):
            greedy, fields = _sampling(traffic, k)
            sess = {"system": systems[which[k]], "turns": [], "fields": fields,
                    "greedy": greedy, "max_history": s["max_history"]}
            for _ in range(turns[k]):
                sess["turns"].append({"user": tokens(users[t]),
                                      "max_tokens": outs[t]})
                t += 1
            sessions.append(sess)
        n_cl = traffic["clients"]
        out["clients"] = [sessions[c::n_cl] for c in range(n_cl)]
        out["stagger_s"] = traffic.get("stagger_s", 0.0)
        return out

    lens = stratified(rng, n_requests, lambda u: quantile(traffic["prompt_tokens"], u))
    outs = stratified(rng, n_requests, lambda u: quantile(traffic["max_tokens"], u))
    reqs = []
    for k in range(n_requests):
        greedy, fields = _sampling(traffic, k)
        # the template adds bos (if the model adds it) and the ai marker
        n_user = lens[k] - 1 - int(add_bos(cfg))
        reqs.append({"messages": [("user", tokens(n_user))],
                     "max_tokens": outs[k], "fields": fields, "greedy": greedy})
    if traffic["loop"] == "open":
        rate = float(traffic["rate_per_s"])
        gaps = stratified(rng, n_requests, lambda u: -math.log(1.0 - u) / rate)
        due = np.cumsum(gaps).tolist()
        for r, d in zip(reqs, due):
            r["due"] = d
        out["requests"] = reqs
    else:
        n_cl = traffic["clients"]
        out["clients"] = [reqs[c::n_cl] for c in range(n_cl)]
        out["stagger_s"] = traffic.get("stagger_s", 0.0)
    return out
