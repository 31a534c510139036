"""CPU tests of the benchmark: the manifest against its contract, the window
arithmetic, the traffic generator, the imports, the reference's decoding
of the GGUF blocks, and whole runs of a small cell on the CPU (correct,
with a served token altered, and the control).

    python3 -m pytest benchmark -q
"""

from __future__ import annotations

import ast
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from benchmark import check, flops, harness, stats, traffic  # noqa: E402
from benchmark.gguf_file import (GGML_Q4_K, GGML_Q5_K, GGML_Q6_K,  # noqa: E402
                                 ids_to_text, text_to_ids)
from benchmark.models.llama_family import dequantize  # noqa: E402
from benchmark.weights import random_blocks  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


# -- the manifest ----------------------------------------------------------------

def test_manifest_names_units_and_keys():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["paths"] == ["benchmark"] and not m["paths"][0].endswith("_torch")
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in m[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(
            os.path.join(ROOT, c["file"]))
        for k in c["reduced"]:
            assert NAME.match(k) and not k.endswith(("_dim", "_rank", "_size"))
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"]), metric
        assert metric["better"] in ("lower", "higher")
        harness.reader(metric["name"])  # every metric has its reader
    for metric in m["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    assert any(x["name"] == "setup_s" for x in m["end_to_end"])


def test_every_cell_reports_what_its_metrics_move():
    m = manifest()
    for w in m["workloads"]:
        spec = harness.cell_spec(w["name"])
        e2e = {x["name"] for x in spec["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert spec["per_layer"], w["name"]
        for x in spec["per_layer"]:
            assert x["moves"] in e2e, (w["name"], x["name"])
        assert spec["check"]["max_logit_gap"] > 0
        # a cell whose traffic samples has its sampled tokens judged too
        samples = spec["traffic"].get("greedy_every", 1) != 1
        assert samples == ("sampled_logit_gap" in spec["check"]), w["name"]


# -- window arithmetic -------------------------------------------------------------

def test_percentile_nearest_rank():
    assert stats.percentile(range(1, 101), 90) == 90
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile([1, 2, 3, math.inf], 90) == math.inf
    assert stats.percentile([], 90) is None


def test_window_arithmetic_with_a_stall():
    """Open loop, one request due each second over [0, 10); the server
    stalls from 4 s to 7 s, so requests due then get their first token at
    7 s; the one due at 9 s fails."""
    recs = []
    for k in range(10):
        due = float(k)
        first = max(due + 0.2, 7.0) if 4 <= k < 7 else due + 0.2
        r = {"due": due, "first": first, "last": first + 1.0, "done": first + 1.0,
             "events": [[first, 1], [first + 0.5, 2], [first + 1.0, 2]]}
        if k == 9:
            r = {"due": due, "error": "HTTP 500"}
        recs.append(r)
    t0, t1 = 0.0, 10.0
    ttft = stats.ttft_ms(recs, t0, t1)
    assert len(ttft) == 10 and ttft[9] == math.inf
    assert ttft[4] == pytest.approx(3000.0) and ttft[6] == pytest.approx(1000.0)
    assert stats.percentile(ttft, 90) == pytest.approx(3000.0)  # 9th of 10
    # tokens arriving inside the window only; the request due at 8 s ends
    # at 9.2 s, so all of its tokens count; nothing after 10 s does
    assert stats.tokens_in_window(recs, t0, t1) == 5 * 9
    # [7, 8): the stalled three's first two chunks and the 7 s request's
    assert stats.tokens_in_window(recs, 7.0, 8.0) == 3 * (1 + 2) + (1 + 2)
    done = stats.completed_in_window(recs, t0, t1)
    assert len(done) == 9
    assert stats.tpot_ms(recs, t0, t1) == pytest.approx([250.0] * 9)
    assert stats.median(stats.tpot_ms(recs, t0, 5.0)) == pytest.approx(250.0)


def test_keys_seen_and_attention_need():
    assert flops.keys_seen(0, 4, 0) == 1 + 2 + 3 + 4
    assert flops.keys_seen(5, 3, 4) == 4 * 3
    ops, byts = flops.attention_need([(10, 1)], 32, 8, 128, 2.0, 2.0, 0)
    assert ops == 4 * 32 * 128 * 11
    assert byts == 10 * 8 * 128 * 2 * 2 + 8 * 128 * 2 * 2 + 32 * 128 * 2 * 2


# -- traffic ------------------------------------------------------------------------

def _cfg() -> dict:
    with open(os.path.join(HERE, "configs", "phi3-mini-4k.json")) as f:
        return json.load(f)


OPEN_LOOP = {"loop": "open", "rate_per_s": 1.5, "stream": True,
             "prompt_tokens": {"dist": "loguniform", "lo": 1024, "hi": 3072},
             "max_tokens": {"dist": "uniform", "lo": 32, "hi": 128},
             "greedy_every": 2, "sampling": {"temperature": 0.7},
             "load": {"n_parallel": 8}}


@pytest.mark.parametrize("name", ["batch", "chat", "open_loop"])
def test_traffic_repeats_by_seed(name):
    if name == "open_loop":
        t = OPEN_LOOP
    else:
        with open(os.path.join(HERE, "traffic", name + ".json")) as f:
            t = json.load(f)
    cfg = _cfg()
    a = traffic.build(cfg, t, 2**33 + 5, 256)
    b = traffic.build(cfg, t, 2**33 + 5, 256)
    c = traffic.build(cfg, t, 2**33 + 6, 256)
    assert a == b and a != c

    def sizes(s):
        if s["loop"] == "open":
            items = s["requests"]
        else:
            items = [x for cl in s["clients"] for x in cl]
        if items and "turns" in items[0]:
            turns = [x for it in items for x in it["turns"]]
            return (sorted(len(x["user"]) for x in turns),
                    sorted(x["max_tokens"] for x in turns),
                    sorted(len(it["turns"]) for it in items))
        return (sorted(len(x["messages"][0][1]) for x in items),
                sorted(x["max_tokens"] for x in items))

    # every seed draws the same sizes (each kind apart), in another order
    assert sizes(a) == sizes(c)
    if t["loop"] == "open":
        assert sorted(np.diff([0] + [r["due"] for r in a["requests"]]).round(9)) == \
            sorted(np.diff([0] + [r["due"] for r in c["requests"]]).round(9))


def test_synthetic_tokenizer_round_trip():
    cfg = _cfg()
    ids = list(range(cfg["vocab_size"]))
    assert text_to_ids(ids_to_text(ids, cfg["vocab_size"]), cfg["vocab_size"]) == ids
    m = traffic.markers(cfg)
    assert m["hi"] == cfg["eos_token_id"] and m["lo"] > m["ai"]
    p = traffic.prompt_ids(cfg, [("system", [9, 9]), ("user", [7]),
                                 ("assistant", [8]), ("user", [6])])
    assert p == [cfg["bos_token_id"], m["system"], 9, 9, 7, m["ai"], 8, 6, m["ai"]]


# -- imports -------------------------------------------------------------------------

def test_no_module_of_the_run_is_jax_or_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.harness, benchmark.loadgen, benchmark.control, "
            "benchmark.models.llama_family, tpu_engine_torch.api.server\n"
            "from benchmark import harness\n"
            "for n in %r: harness.reader(n)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % (
                ROOT, [x["name"] for x in manifest()["per_layer"]
                       + manifest()["end_to_end"]]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    top = set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))
    assert "tpu_engine_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "tpu_engine"}


def test_reference_imports_nothing_of_the_program():
    for sub in ("models", "."):
        d = os.path.join(HERE, sub)
        for f in os.listdir(d):
            if not f.endswith(".py") or (sub == "." and f not in (
                    "check.py", "weights.py", "gguf_file.py", "traffic.py")):
                continue
            tree = ast.parse(open(os.path.join(d, f)).read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""] if isinstance(node, ast.ImportFrom)
                         else [])
                for n in names:
                    top = n.split(".")[0]
                    assert top not in ("tpu_engine_torch", "tpu_engine", "jax"), (f, n)


# -- the reference's own decoding of ggml blocks ----------------------------------------

@pytest.mark.parametrize("ty,fn", [(GGML_Q4_K, "dequant_q4_k"),
                                   (GGML_Q5_K, "dequant_q5_k"),
                                   (GGML_Q6_K, "dequant_q6_k")])
def test_reference_dequantize_matches_ggml(ty, fn):
    from tpu_engine_torch.quant import formats

    g = torch.Generator().manual_seed(3)
    raw = random_blocks(g, 256 * 40, ty, "cpu").reshape(-1)
    ours = dequantize(raw, ty, (40, 256)).numpy().reshape(-1)
    theirs = np.asarray(getattr(formats, fn)(raw.numpy()), np.float32).reshape(-1)
    np.testing.assert_array_equal(ours, theirs)


# -- the check's rule ---------------------------------------------------------------------

def test_admission_gap_of_a_greedy_token_is_its_gap_below_the_best():
    z = torch.tensor([[3.0, 1.0, 2.5, -4.0], [0.0, 2.0, 1.0, 1.5]])
    r = check.rule({"temperature": 0.0, "repeat_penalty": 1.0})
    got = check.admission_gaps(z, [2, 1], r)
    assert got.tolist() == pytest.approx([0.5, 0.0], abs=1e-6)


def test_admission_gap_under_top_k_top_p_and_min_p():
    # probabilities of ids 0..4 after softmax: about .64, .24, .09, .03, ...
    z = torch.tensor([[4.0, 3.0, 2.0, 0.9, -5.0, -6.0]])
    r = check.rule({"temperature": 0.7, "top_k": 4, "top_p": 0.95,
                    "min_p": 0.05, "repeat_penalty": 1.0})
    gaps = [float(check.admission_gaps(z, [t], r)) for t in range(6)]
    assert gaps[:3] == [0.0, 0.0, 0.0]
    # id 3 lies under min_p (its probability under 5% of the best's) and
    # past top_p (.97 of the mass before it): the least rise that admits it
    # brings the mass before it under .95, which clears min_p as well
    before = math.exp(4.0) + math.exp(3.0) + math.exp(2.0)
    rise = math.log(before * (1 / 0.95 - 1)) - 0.9
    assert rise > 4.0 + math.log(0.05) - 0.9
    assert gaps[3] == pytest.approx(rise, abs=1e-6)
    # id 4 is outside top_k 4 too: it has to pass id 3 at least
    assert gaps[4] > 5.9
    wide = check.rule({"temperature": 0.7, "top_k": 40, "top_p": 1.0,
                       "min_p": 0.0, "repeat_penalty": 1.0})
    assert float(check.admission_gaps(z, [5], wide).max()) == 0.0


def test_repeat_penalty_over_the_last_tokens():
    seq = [5, 1, 2, 3]
    z = torch.tensor([[2.0, 2.2, -1.0, 0.5, 0.0, 3.0],
                      [2.0, 2.2, -1.0, 0.5, 0.0, 3.0]])
    r = check.rule({"temperature": 0.7, "repeat_penalty": 2.0,
                    "repeat_last_n": 2})
    # position 1 sees [5, 1], position 2 sees [1, 2]
    got = check.penalized(z, seq, 1, r)
    assert got[0].tolist() == pytest.approx([2.0, 1.1, -1.0, 0.5, 0.0, 1.5])
    assert got[1].tolist() == pytest.approx([2.0, 1.1, -2.0, 0.5, 0.0, 3.0])


def test_sample_takes_replies_cut_by_the_window():
    recs = [{"client": 0, "k": 0, "greedy": True, "text": "ab", "done": 1.0},
            {"client": 1, "k": 0, "greedy": True, "text": "abcdef"},
            {"client": 2, "k": 0, "greedy": True, "text": "abc", "error": "x"},
            {"client": 3, "k": 0, "greedy": False, "text": "abcdefgh"}]
    got = check.sample(recs, 2**33 + 1, 4)
    assert [r["client"] for r in got] == [1, 0]
    assert [r["client"] for r in check.sample(recs, 7, 4, greedy=False)] == [3]


# -- whole runs of a small cell on the CPU ----------------------------------------------

def small_spec(cell: str = "phi3-mini-4k.batch") -> dict:
    """The cell at a size a CPU test holds: hidden 1024, 2 layers, vocab
    512, 2 slots, short prompts and replies."""
    spec = harness.cell_spec(cell)
    cfg = dict(spec["cfg"], hidden_size=1024, intermediate_size=2048,
               num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=8,
               vocab_size=512, eos_token_id=2)
    t = dict(spec["traffic"], prompt_tokens={"dist": "loguniform", "lo": 16, "hi": 48},
             max_tokens={"dist": "uniform", "lo": 8, "hi": 20},
             load=dict(spec["traffic"]["load"], n_parallel=2, ctx_len=512))
    if "clients" in t:
        t["clients"] = 2
    if "sessions" in t:
        t.update(sessions=dict(t["sessions"], system_tokens=16, max_history=160),
                 user_tokens={"dist": "uniform", "lo": 8, "hi": 24})
    return dict(spec, cfg=cfg, traffic=t)


def _run(spec, **kw):
    import time

    return harness.run_cell(spec, 2**33 + 21, 12.0, False, time.monotonic(),
                            device="cpu", **kw)


def test_cpu_run_is_correct_and_the_control_is_not():
    result, compared = _run(small_spec(), control=True)
    got = {n: v for n, v, _ in compared}
    assert result["failed"] == 0 and got["nothing_checked"] == 0
    assert got["weights_redrawn_apart"] == 0 and got["token_count_mismatches"] == 0
    # on the CPU the program runs the plain float32 path, as the reference
    # does: only a near-tie summed in another order can part them
    assert got["max_logit_gap"] < 0.05
    # float8 in the program's place puts other tokens first
    assert got["control_max_logit_gap"] > 3 * got["max_logit_gap"] + 0.01
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"output_tokens_per_s", "setup_s"}


def test_cpu_run_with_a_served_token_altered_is_not_correct(monkeypatch):
    """A token altered where it is produced: the device sampler's every
    third draw is moved to another id."""
    from tpu_engine_torch.sampling import device as sdev
    from tpu_engine_torch.serve import ops

    orig = sdev.sample_step
    calls = {"n": 0}

    def altered(logits, *a, **kw):
        tok, st = orig(logits, *a, **kw)
        calls["n"] += 1
        if calls["n"] % 3 == 0:
            tok = (tok + logits.shape[-1] // 2) % logits.shape[-1]
        return tok, st

    monkeypatch.setattr(sdev, "sample_step", altered)
    monkeypatch.setattr(ops, "sample_step", altered)
    spec = small_spec()
    result, compared = _run(spec)
    assert calls["n"] > 0
    assert result["correct"] is False
    got = {n: v for n, v, _ in compared}
    assert got["nothing_checked"] == 0
    assert got["max_logit_gap"] > spec["check"]["max_logit_gap"]


def test_cpu_chat_run_judges_sampled_tokens_and_the_control_fails():
    result, compared = _run(small_spec("phi3-mini-4k.chat"), control=True)
    got = {n: v for n, v, _ in compared}
    assert result["failed"] == 0 and got["nothing_checked"] == 0
    assert got["sampled_logit_gap_tokens"] > 0 and got["max_logit_gap_tokens"] > 0
    # the plain float32 path on both sides: every sampled token is one of
    # the reference's candidates, but for a near-tie summed in another order
    assert got["sampled_logit_gap"] < 0.05 and got["max_logit_gap"] < 0.05
    assert got["control_max_logit_gap"] > 3 * got["max_logit_gap"] + 0.01
    assert got["control_sampled_logit_gap"] > 3 * got["sampled_logit_gap"] + 0.01


def test_cpu_chat_run_with_a_sampler_that_skips_its_filters_is_not_correct(monkeypatch):
    """The device sampler draws from all of its captured candidates, as if
    top_k, top_p and min_p were not asked for."""
    from tpu_engine_torch.sampling import device as sdev

    calls = {"n": 0}

    def unfiltered(logits, params):
        calls["n"] += 1
        return torch.topk(logits, sdev.DEVICE_TOP_K, dim=-1)

    monkeypatch.setattr(sdev, "candidates", unfiltered)
    spec = small_spec("phi3-mini-4k.chat")
    # this model's logits lie a few tenths apart, so it takes the limit
    # its own sound runs allow (under 0.05, the test above), not the card's
    spec["check"] = dict(spec["check"], sampled_logit_gap=0.05)
    result, compared = _run(spec)
    assert calls["n"] > 0
    assert result["correct"] is False
    got = {n: v for n, v, _ in compared}
    assert got["sampled_logit_gap"] > 0.05
    assert got["max_logit_gap"] <= spec["check"]["max_logit_gap"]


@pytest.mark.chip
@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_control_fails_the_limit_at_the_cells_size(chip, cell):
    """On the card, at the cell's own size: the program's gap stays under
    the cell's limit and the float8 control's lies above it."""
    import time

    spec = harness.cell_spec(cell)
    _, compared = harness.run_cell(spec, 2**33 + 31, 25.0, False,
                                   time.monotonic(), control=True)
    got = {n: v for n, v, _ in compared}
    for name in ("max_logit_gap", "sampled_logit_gap"):
        if name in spec["check"]:
            limit = spec["check"][name]
            assert got[name] <= limit < got["control_" + name], name
