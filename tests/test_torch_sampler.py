"""The port's device sampler (tpu_engine_torch.sampling.device) against the
JAX package's. JAX PRNG keys and torch generators give different numbers,
so the parity is held on what does not depend on them:
  - greedy sample_step gives identical tokens (penalties, ignore_eos,
    grammar bank), over several chained steps;
  - the filtered, penalized, temperature-scaled candidate distribution the
    draw reads (captured from both with the Gumbel noise set to zero) is
    equal to 1e-6 (f32 softmax of the same f32 values);
  - with the same Gumbel noise fed to both (the port draws per token id:
    each JAX candidate's draw on its token), the sampled tokens are equal;
  - a change of the logits far below the draws' spread that reorders
    candidates leaves the port's draws as they were;
  - grammar-bank state advance and the expanded token tables are equal;
  - seeded draws are deterministic within the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.models import tokenizer_metadata
from tpu_engine.sampling import device as J
from tpu_engine_torch.sampling import device as T
from tpu_engine_torch.sampling.chain import SamplingParams as TSP
from tpu_engine.sampling import SamplingParams as JSP

torch.set_num_threads(2)

V, S = 300, 4
HIST = [[5, 5, 7, 9, 5, 11, 7, 7, 13, 5, 5, 9], [1, 2, 3], [], [42] * 20]
EOS = 2

KNOBS = [
    dict(temperature=0.0, repeat_penalty=1.3, frequency_penalty=0.4,
         presence_penalty=0.2, repeat_last_n=10),
    dict(temperature=0.8, top_k=20, top_p=0.9, min_p=0.05,
         repeat_penalty=1.1, repeat_last_n=64),
    dict(temperature=1.3, top_k=64, top_p=0.5),
    dict(temperature=0.6, top_k=5, ignore_eos=True),
]


def both_params(knobs, eog=(EOS,)):
    jp = J.params_from_host([JSP(**k) for k in knobs], eog_ids=eog)
    tp = T.params_from_host([TSP(**k) for k in knobs], eog_ids=eog,
                            device="cpu")
    return jp, tp


def both_states(gstate=None):
    js = J.new_state(S, seed=0)
    js = J.DeviceSamplerState(ring=J.ring_from_tokens(HIST, S), keys=js.keys,
                              gstate=js.gstate if gstate is None
                              else jnp.asarray(gstate, jnp.int32))
    ts = T.new_state(S, seed=0, gstate=gstate, device="cpu")
    ts.ring = T.ring_from_tokens(HIST, S, device="cpu")
    return js, ts


def logits_for(seed):
    x = np.random.default_rng(seed).standard_normal((S, V)).astype(np.float32)
    x[:, EOS] += 4.0  # EOS often the argmax: exercises the ignore_eos ban
    return x * 3


@pytest.mark.parametrize("knob", range(len(KNOBS)))
def test_greedy_tokens_identical_over_steps(knob):
    knobs = [dict(KNOBS[knob], temperature=0.0)] * S
    jp, tp = both_params(knobs)
    assert jp.all_greedy and tp.all_greedy
    js, ts = both_states()
    for step in range(4):
        x = logits_for(10 * knob + step)
        jt, js = J.sample_step(jnp.asarray(x), jp, js)
        tt, ts = T.sample_step(torch.from_numpy(x), tp, ts)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(ts.ring.numpy(), np.asarray(js.ring))


def _jax_scores(monkeypatch, x, jp, js, noise):
    """The [S, DK] scores JAX's sample_step takes the argmax of, with the
    Gumbel draw replaced by `noise`, plus the candidate token ids."""
    seen = {}
    real_argmax, real_top_k = jnp.argmax, jax.lax.top_k

    def argmax(a, axis=None, **kw):
        seen["score"] = np.asarray(a)
        return real_argmax(a, axis=axis, **kw)

    def top_k(a, k):
        v, i = real_top_k(a, k)
        seen["idx"] = np.asarray(i)
        return v, i

    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape: jnp.asarray(noise[0]))
    monkeypatch.setattr(jnp, "argmax", argmax)
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    toks, _ = J.sample_step(jnp.asarray(x), jp, js)
    monkeypatch.undo()
    return seen["score"], seen["idx"], np.asarray(toks)


def _dense_probs(score, idx):
    p = torch.softmax(torch.from_numpy(np.array(score)), dim=-1).numpy()
    out = np.zeros((score.shape[0], V), np.float64)
    for s in range(score.shape[0]):
        np.add.at(out[s], idx[s], p[s])
    return out


def test_filtered_distribution_matches(monkeypatch):
    jp, tp = both_params(KNOBS)
    js, ts = both_states()
    x = logits_for(99)
    zero = np.zeros((1, T.DEVICE_TOP_K), np.float32)
    jscore, jidx, _ = _jax_scores(monkeypatch, x, jp, js, zero)
    v, idx = T.candidates(T.filtered_logits(torch.from_numpy(x), tp, ts), tp)
    tscore = (v / torch.clamp(tp.temp, min=1e-6)[:, None]).numpy()
    greedy = np.asarray(jp.temp) <= 0
    tscore[greedy] = v.numpy()[greedy]
    np.testing.assert_allclose(_dense_probs(tscore, idx.numpy()),
                               _dense_probs(jscore, jidx), atol=1e-6)
    # slot 3 bans EOS (ignore_eos): never a candidate
    assert _dense_probs(tscore, idx.numpy())[3, EOS] == 0.0


@pytest.mark.parametrize("draw", range(6))
def test_same_noise_same_tokens(monkeypatch, draw):
    jp, tp = both_params(KNOBS)
    js, ts = both_states()
    x = logits_for(50 + draw)
    noise = np.random.default_rng(draw).gumbel(
        size=(1, T.DEVICE_TOP_K)).astype(np.float32)
    _, jidx, jt = _jax_scores(monkeypatch, x, jp, js, noise)
    # the port draws per token id: each JAX candidate's draw on its token
    by_token = np.zeros((S, V), np.float32)
    for s in range(S):
        by_token[s, jidx[s]] = noise[0]
    monkeypatch.setattr(T, "gumbel_noise",
                        lambda shape, gen, device: torch.from_numpy(
                            by_token.copy()))
    tt, _ = T.sample_step(torch.from_numpy(x), tp, ts)
    np.testing.assert_array_equal(tt.numpy(), jt)


def _bank():
    NS = 4
    mask = np.ones((NS, V), bool)
    trans = np.zeros((NS, V), np.int32)
    mask[1] = False
    mask[1, [3, 5]] = True
    trans[1, 3], trans[1, 5] = 2, 3
    mask[2] = False
    mask[2, [7, 8]] = True
    trans[2, 7], trans[2, 8] = 2, 1
    mask[3] = False
    mask[3, EOS] = True  # accept state: only EOG legal
    trans[3, EOS] = 3
    return (J.GrammarBank(mask=jnp.asarray(mask), trans=jnp.asarray(trans)),
            T.GrammarBank(mask=torch.from_numpy(mask),
                          trans=torch.from_numpy(trans)))


def test_grammar_bank_advance_identical():
    jb, tb = _bank()
    knobs = [dict(temperature=0.0, ignore_eos=True)] * S
    jp, tp = both_params(knobs)
    js, ts = both_states(gstate=[0, 1, 2, 3])
    for step in range(5):
        x = logits_for(200 + step)
        jt, js = J.sample_step(jnp.asarray(x), jp, js, gbank=jb)
        tt, ts = T.sample_step(torch.from_numpy(x), tp, ts, gbank=tb)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(ts.gstate.numpy(), np.asarray(js.gstate))
    # the accept-state slot keeps EOG although it asked to ignore it
    assert int(tt[3]) == EOS


def test_expand_token_tables_identical():
    from tpu_engine.grammar.dfa import compile_byte_dfa
    from tpu_engine.tokenizer import Tokenizer as JTok
    from tpu_engine_torch.grammar.dfa import compile_byte_dfa as t_compile
    from tpu_engine_torch.tokenizer import Tokenizer as TTok

    md = tokenizer_metadata(384)
    grammar = 'root ::= ("yes" | "no") " " [0-9]+'
    jm, jt = J.expand_token_tables(compile_byte_dfa(grammar), JTok.from_gguf_metadata(md))
    tm, tt = T.expand_token_tables(t_compile(grammar), TTok.from_gguf_metadata(md),
                                   device="cpu")
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    jb, tb = J.passthrough_bank(V, 3), T.passthrough_bank(V, 3, device="cpu")
    np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask))
    np.testing.assert_array_equal(tb.trans.numpy(), np.asarray(jb.trans))


def test_seeded_draws_deterministic_within_port():
    _, tp = both_params(KNOBS)

    def run(seed):
        st = T.new_state(S, seed=seed, device="cpu")
        out = []
        for step in range(5):
            tok, st = T.sample_step(torch.from_numpy(logits_for(300 + step)),
                                    tp, st)
            out.append(tok.numpy())
        return np.stack(out)

    np.testing.assert_array_equal(run(7), run(7))
    assert not np.array_equal(run(7), run(8))


def test_draws_follow_tokens_not_sort_order():
    """Logits in close pairs (1e-4 apart), and the same logits with every
    pair's order swapped: with one generator seed the port draws the same
    tokens from both, on every row and seed, since each token keeps its
    own Gumbel draw and its score moves by 1e-4 / T. A draw per sorted
    position (the JAX package's, and the port's before) hands each of a
    swapped pair the other's draw, and the picks part: this test fails
    there. It is what held a data-parallel rank's draws to one rank's on
    the card, where the rank's logits round apart by about 1e-2."""
    rng = np.random.default_rng(4)
    x = np.full((S, V), -30.0, np.float32)
    y = x.copy()
    for s in range(S):
        toks = rng.permutation(V)[:64]
        base = np.sort(rng.standard_normal(32)).astype(np.float32)[::-1]
        for k, c in enumerate(base):
            a, b = toks[2 * k], toks[2 * k + 1]
            x[s, a], x[s, b] = c, c - 1e-4
            y[s, a], y[s, b] = c - 1e-4, c
    _, tp = both_params([dict(temperature=1.0, top_k=64, top_p=1.0,
                              min_p=0.0, repeat_penalty=1.0)] * S)
    differ = 0
    for seed in range(40):
        got = [T.sample_step(torch.from_numpy(z), tp,
                             T.new_state(S, seed=seed, device="cpu"))[0]
               for z in (x, y)]
        differ += int((got[0] != got[1]).sum())
    assert differ == 0
