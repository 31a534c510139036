"""CPU tests of the benchmark: the manifest against its contract, the window
arithmetic, the traffic generator, the imports, the reference's decoding
of the GGUF blocks, and whole runs of a small cell on the CPU (correct,
with a served token altered, and the control).

    python3 -m pytest benchmark -q
"""

from __future__ import annotations

import ast
import hashlib
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

from benchmark import (check, flops, gguf_file, harness, stats,  # noqa: E402
                       traffic, weights)
from benchmark.gguf_file import (GGML_F32, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K,  # noqa: E402
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


# -- a configuration's own architecture ----------------------------------------------

# The llama family's files as the harness wrote them while their tensor
# table and metadata were built in weights.py and gguf_file.py, before
# models/llama_family.py gave them: computed on that code, on the CPU, as
# the sha256 of gguf_file.header_bytes(model_metadata(cfg), tensor_table(cfg))
# of each configs/ file at its own size, and the int64 byte sums that
# weights.draw_tensors gives for it at small_cfg's size from seed 2**33 + 21.
# A change to the table, the metadata or the draws moves them.
PINNED = {
    "phi3-mini-4k": (
        "edac05c0dd062bc18b66090629542463fcc59616d47a27575306033832863eff",
        [38704821, 445785, 54517644, 449909, 272534360, 77501675, 448340,
         310069578, 155139599, 450248, 272420073, 77644015, 448449, 310177104,
         218264284]),
    "qwen2-7b-14l": (
        "c7532f551bdd42396b701536bf6e4e28f6931e719ac63420abc3d95ebd2b87c9",
        [38704821, 445785, 54517644, 449909, 77586556, 77598003, 77547782,
         517946, 509440, 509651, 77461455, 458754, 154974915, 155102638,
         155109095, 451611, 77469197, 77587595, 109128512, 507398, 513630,
         513588, 77666731, 452519, 155107212, 155084536, 218266617]),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_llama_family_files_keep_their_bytes(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        cfg = json.load(f)
    header = gguf_file.header_bytes(gguf_file.model_metadata(cfg),
                                    weights.tensor_table(cfg))
    sums = [int(d.to(torch.int64).sum()) for _, _, _, d in
            weights.draw_tensors(small_cfg(cfg), 2**33 + 21, "cpu")]
    assert (hashlib.sha256(header).hexdigest(), sums) == PINNED[name]


TOY = {"reference": "toy_hybrid_moe", "hidden_size": 256, "expert_width": 256,
       "num_experts": 4, "num_experts_per_tok": 2, "num_hidden_layers": 2,
       "vocab_size": 512, "bos_token_id": 1, "eos_token_id": 2}


def toy_module():
    """A model module of an architecture outside the llama family: a short
    convolution layer and an attention layer, each with stacked experts
    behind a router with an expert bias."""
    import types

    from benchmark.gguf_file import ARRAY, F32, I32, STRING, U32

    def tensor_table(cfg):
        E, F, X, V = (cfg["hidden_size"], cfg["expert_width"],
                      cfg["num_experts"], cfg["vocab_size"])
        t = [("token_embd.weight", (V, E), GGML_Q4_K, "weight"),
             ("token_embd_norm.weight", (E,), GGML_F32, "norm")]
        for i in range(cfg["num_hidden_layers"]):
            p = f"blk.{i}."
            t.append((p + "attn_norm.weight", (E,), GGML_F32, "norm"))
            if i % 2 == 0:
                t += [(p + "shortconv.in_proj.weight", (3 * E, E), GGML_Q4_K, "weight"),
                      (p + "shortconv.conv.weight", (E, 3), GGML_F32, "weight")]
            else:
                t += [(p + "attn_q_norm.weight", (64,), GGML_F32, "norm"),
                      (p + "attn_q.weight", (E, E), GGML_Q4_K, "weight")]
            t += [(p + "ffn_gate_inp.weight", (X, E), GGML_F32, "weight"),
                  (p + "exp_probs_b.bias", (X,), GGML_F32, "bias"),
                  (p + "ffn_gate_exps.weight", (X, F, E), GGML_Q4_K, "weight"),
                  (p + "ffn_down_exps.weight", (X, E, F), GGML_Q6_K, "weight")]
        return t

    def gguf_metadata(cfg):
        a, L = "toy_hybrid_moe", cfg["num_hidden_layers"]
        return [("general.architecture", STRING, a),
                ("general.name", STRING, "toy"),
                (f"{a}.block_count", U32, L),
                (f"{a}.embedding_length", U32, cfg["hidden_size"]),
                (f"{a}.attention.head_count_kv", (ARRAY, I32),
                 [0 if i % 2 == 0 else 4 for i in range(L)]),
                (f"{a}.expert_count", U32, cfg["num_experts"]),
                (f"{a}.expert_used_count", U32, cfg["num_experts_per_tok"]),
                (f"{a}.rope.freq_base", F32, 1e6)]

    class Reference:
        def __init__(self, cfg, raw, precision="f32"):
            self.cfg, self.raw, self.precision = cfg, raw, precision

    mod = types.ModuleType("benchmark.models.toy_hybrid_moe")
    mod.tensor_table, mod.gguf_metadata = tensor_table, gguf_metadata
    mod.Reference = Reference
    return mod


def test_a_foreign_architecture_round_trips(tmp_path, monkeypatch):
    """A module of its own gives the tensors (3-D experts in Q4_K and Q6_K,
    F32 tensors drawn as weights) and the metadata (a per-layer array,
    expert counts); the file written reads back whole through the
    program's reader, and the check's reference draws the same bytes."""
    from tpu_engine_torch.gguf.reader import read_gguf

    mod = toy_module()
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    cfg, seed = dict(TOY), 2**33 + 41
    path = str(tmp_path / "toy.gguf")
    sums = harness.write_gguf(cfg, seed, "cpu", path)
    table = mod.tensor_table(cfg)
    md = mod.gguf_metadata(cfg)
    ref, ref_sums = check.reference(cfg, seed, "cpu")
    assert ref_sums == sums
    f = read_gguf(path)
    try:
        assert list(f.tensors) == [n for n, *_ in table]
        for (name, shape, ty, draw), s in zip(table, sums):
            ti = f.tensors[name]
            assert (ti.shape, int(ti.ggml_type)) == (shape, ty)
            data = f.tensor_bytes(name).copy()
            assert int(data.astype(np.int64).sum()) == s
            np.testing.assert_array_equal(data, ref.raw[name][2].numpy())
            if ty == GGML_Q4_K and len(shape) == 3:  # one decoding, any rank
                np.testing.assert_array_equal(
                    f.dequantize(name), dequantize(ref.raw[name][2], ty, shape).numpy())
            if ty == GGML_F32:  # drawn as its draw says: (scale, offset)
                x = f.tensor_array(name).copy()
                scale, offset = {"norm": (0.1, 1.0), "bias": (0.1, 0.0),
                                 "weight": (0.02, 0.0)}[draw]
                assert abs(x.mean() - offset) < 5 * scale / math.sqrt(x.size), name
                if x.size >= 64:
                    assert 0.7 * scale < x.std() < 1.3 * scale, name
        for key, _, value in md:
            got = f.metadata[key]
            got = got.tolist() if hasattr(got, "tolist") else got
            assert got == value, key
        assert f.metadata["tokenizer.ggml.tokens"] == gguf_file.vocab_chars(512)
        assert f.metadata["tokenizer.ggml.add_bos_token"] is True
        assert list(f.metadata)[:len(md)] == [k for k, _, _ in md]
    finally:
        f.close()


def test_a_new_cell_reports_every_end_to_end_metric(tmp_path, monkeypatch):
    """BENCHMARK.json with one configuration and one cell appended and
    nothing else changed: the new cell reports output_tokens_per_s and
    setup_s, and what each of its per-layer metrics moves is among them."""
    import shutil

    m = manifest()
    m["configs"].append({"name": "qwen2-7b-14l",
                         "source": "https://huggingface.co/Qwen/Qwen2-7B-Instruct",
                         "file": "benchmark/configs/qwen2-7b-14l.json",
                         "reduced": ["num_hidden_layers"], "why": "GQA, qkv bias"})
    m["workloads"].append({"name": "qwen2-7b-14l.chat", "config": "qwen2-7b-14l",
                           "traffic": "chat", "chips": 1, "why": "chat on qwen2"})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(m))
    # the cell's files: the chat traffic, and a check file of its own
    here = tmp_path / "benchmark"
    shutil.copytree(os.path.join(HERE, "traffic"), here / "traffic")
    (here / "checks").mkdir()
    shutil.copy(os.path.join(HERE, "checks", "phi3-mini-4k.chat.json"),
                here / "checks" / "qwen2-7b-14l.chat.json")
    monkeypatch.setattr(harness, "HERE", str(here))
    spec = harness.cell_spec("qwen2-7b-14l.chat", manifest_path=str(path))
    e2e = {x["name"] for x in spec["end_to_end"]}
    assert e2e == {"output_tokens_per_s", "setup_s"}
    assert spec["per_layer"] and all(x["moves"] in e2e for x in spec["per_layer"])
    assert spec["cfg"]["num_hidden_layers"] == 14


# -- the reduced trace -----------------------------------------------------------------

class _Event:
    """A profiler event as trace.reduce reads it."""

    def __init__(self, name, start, dur, corr, on_device):
        self._v = (name, start, dur, corr, on_device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def activity_type(self):
        return "kernel" if self._v[4] else "cuda_runtime"

    def correlation_id(self):
        return self._v[3]

    def linked_correlation_id(self):
        return 0

    def device_type(self):
        return "DeviceType.CUDA" if self._v[4] else "DeviceType.CPU"


def test_reduce_keeps_every_kernels_time():
    """12 kernel names, each launched twice, one launch of each cut by the
    window's end: every name's time in kernel_s, the ten longest in
    device_ops, with the same seconds."""
    from benchmark import trace

    t0, t1, ms = 10**12, 10**12 + 10**9, 10**6
    evs = []
    for k in range(12):
        raw = f"void ns::(anonymous namespace)::kern{k:02d}<float, 4>(float*, int)"
        evs.append(_Event(raw, t0 + 2 * k * 10 * ms, (k + 1) * ms, 2 * k, True))
        # the second launch runs 1 ms into the window's end
        evs.append(_Event(raw, t1 - ms, 5 * ms, 2 * k + 1, True))
        evs.append(_Event("cudaLaunchKernel", t0 + k * ms, 1000, 2 * k, False))
    out = trace.reduce(evs, t0, t1, trace.Tracer(2, 512), None)
    want = {f"ns::kern{k:02d}": ((k + 1) + 1) / 1e3 for k in range(12)}
    assert out["kernel_s"] == pytest.approx(want)
    top = sorted(want, key=lambda n: -want[n])[:10]
    assert [n for n, _ in out["device_ops"]] == top
    assert sum(v for _, v in out["device_ops"]) == pytest.approx(
        sum(out["kernel_s"][n] for n in top))
    assert sum(out["kernel_s"].values()) == pytest.approx(sum(want.values()))


# -- whole runs of a small cell on the CPU ----------------------------------------------

def small_cfg(cfg: dict) -> dict:
    """A configuration at a size a CPU test holds: hidden 1024, 2 layers,
    vocab 512."""
    return dict(cfg, hidden_size=1024, intermediate_size=2048,
                num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=8,
                vocab_size=512, eos_token_id=2)


def small_spec(cell: str = "phi3-mini-4k.batch") -> dict:
    """The cell at a size a CPU test holds: small_cfg, 2 slots, short
    prompts and replies."""
    spec = harness.cell_spec(cell)
    cfg = small_cfg(spec["cfg"])
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
