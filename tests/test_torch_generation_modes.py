"""The port's two-phase mode and speculative decoding against the JAX
package's, on the CPU.

The same numpy weights and requests go through both engines at a small
size (the JAX engine with its "reference" attention, the port with its
plain versions). Across the packages the greedy streams and the stats are
compared (stochastic samples cannot match: threefry against Philox);
within the port, two-phase, chunked, naive and speculative runs give the
same token streams under every sampler. Each JAX engine's streams are
computed once per module, and every engine loop is bounded by a step
count.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.generation as J
from paddle_tpu.monitor import stat_get as jstat
import paddle_tpu_torch.generation as T
from paddle_tpu_torch.generation import engine as tengine
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.kernels import layer_norm as tln
from paddle_tpu_torch.monitor import stat_get as tstat

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)

CFG_KW = dict(vocab_size=128, hidden=64, layers=2, heads=4, max_seq_len=64)
JCFG, TCFG = J.DecoderConfig(**CFG_KW), T.DecoderConfig(**CFG_KW)
DRAFT_KW = dict(CFG_KW, layers=1)
# a short ladder: the JAX two-phase engine compiles one prefill a rung
LADDER = "8,16,32,64"
# the pool of tests/test_torch_generation.py: prefix hits, copy-on-write
# and preemption in a run of _prompts()
GEO = dict(num_blocks=18, block_size=4, decode_width=3, prefill_chunk=4)
ROOMY = dict(GEO, num_blocks=64)
TWO_PHASE = dict(ROOMY, prefill_chunk=0, prefill_buckets=LADDER)
# any engine loop below ends within this many steps or fails
MAX_STEPS = 400
STATS = ("STAT_generation_prefills", "STAT_generation_tokens",
         "STAT_generation_pad_tokens", "STAT_generation_evictions",
         "STAT_generation_prefix_hits", "STAT_generation_prefix_cow_copies",
         "STAT_generation_spec_proposed", "STAT_generation_spec_accepted",
         "STAT_generation_draft_faults")


@pytest.fixture(scope="module")
def params():
    return T.init_params(TCFG, seed=0)


@pytest.fixture(scope="module")
def draft_params():
    return T.init_params(T.DecoderConfig(**DRAFT_KW), seed=5)


def _prompts():
    """Two prompts sharing a 10-token prefix, a short one, two more on the
    prefix, then long ones that run GEO's pool dry."""
    rng = np.random.default_rng(1)

    def draw(n):
        return [int(x) for x in rng.integers(0, 128, n)]
    shared = draw(10)
    return [shared + draw(3), shared + draw(9), [1, 2, 3, 4, 5],
            shared + draw(1), shared + draw(6), draw(30), draw(21),
            draw(14), draw(1)]


def _spec_prompts():
    """Repetitive prompts (a period-3 pattern then a marker): the ngram
    drafter finds matches in them."""
    base = [5, 9, 2] * 4
    return [base + [i] for i in range(4)] + [[7, 1, 7, 1, 7, 1, 7], [3] * 9]


def _stochastic(pkg, i):
    return (pkg.SamplingParams(),
            pkg.SamplingParams(temperature=0.8, seed=11 + i),
            pkg.SamplingParams(temperature=0.9, top_k=8, seed=22 + i),
            pkg.SamplingParams(temperature=0.7, top_p=0.9, seed=33 + i))[i % 4]


def _requests(pkg, prompts, sampling=None, new=(12, 7)):
    return [pkg.GenerationRequest(
        prompt=p, max_new_tokens=new[0] + i % new[1], request_id=i,
        sampling=sampling(pkg, i) if sampling else pkg.SamplingParams())
        for i, p in enumerate(prompts)]


def _run(pkg, cfg, params, reqs, **kw):
    """(streams by request id, stat deltas, engine) of one engine run."""
    stat = jstat if pkg is J else tstat
    before = {n: stat(n) for n in STATS}
    if pkg is T:
        kw.setdefault("device", "cpu")
    eng = pkg.GenerationEngine(cfg, params, **kw)
    res = eng.generate(reqs, max_steps=MAX_STEPS)
    return ({r.request_id: r.tokens for r in res},
            {n: stat(n) - before[n] for n in STATS}, eng)


def _port(params, reqs, **kw):
    return _run(T, TCFG, params, reqs, **kw)


# --------------------------------------------------------------------------
# the JAX engine's runs, once per module
# --------------------------------------------------------------------------

# (prompts, engine options) of each run, from (params, draft params)
JAX_RUNS = {
    "two_phase": lambda p, d: (_prompts(), dict(TWO_PHASE)),
    "two_phase_tight": lambda p, d: (
        _prompts(), dict(GEO, prefill_chunk=0, prefill_buckets=LADDER)),
    "ngram_k2": lambda p, d: (_spec_prompts(), dict(ROOMY, spec_tokens=2)),
    "ngram_k3": lambda p, d: (_spec_prompts(), dict(ROOMY, spec_tokens=3)),
    "model_self": lambda p, d: (_spec_prompts()[:3], dict(
        ROOMY, spec_tokens=2, draft="model", draft_cfg="target",
        draft_params=p)),
    "model_1layer": lambda p, d: (_spec_prompts(), dict(
        ROOMY, spec_tokens=3, draft="model", draft_cfg="draft",
        draft_params=d)),
    "spec_geo": lambda p, d: (_prompts(), dict(GEO, spec_tokens=2)),
}


def _cfgs(kw, pkg):
    kw = dict(kw)
    if kw.get("draft_cfg") == "target":
        kw["draft_cfg"] = pkg.DecoderConfig(**CFG_KW)
    elif kw.get("draft_cfg") == "draft":
        kw["draft_cfg"] = pkg.DecoderConfig(**DRAFT_KW)
    return kw


@pytest.fixture(scope="module")
def jax_runs(params, draft_params):
    out = {}
    for name, make in JAX_RUNS.items():
        prompts, kw = make(params, draft_params)
        streams, stats, _ = _run(J, JCFG, params, _requests(J, prompts),
                                 **_cfgs(kw, J))
        out[name] = (streams, stats)
    return out


@pytest.mark.parametrize("name", sorted(JAX_RUNS))
def test_greedy_streams_and_stats_equal_the_jax_engine(params, draft_params,
                                                       jax_runs, name):
    prompts, kw = JAX_RUNS[name](params, draft_params)
    streams, stats, _ = _port(params, _requests(T, prompts), **_cfgs(kw, T))
    jstreams, jstats = jax_runs[name]
    assert streams == jstreams
    assert stats == jstats
    # each run exercised what it is meant to
    if "spec_tokens" in kw:
        assert stats["STAT_generation_spec_proposed"] > 0
        assert stats["STAT_generation_draft_faults"] == 0
        # a random 1-layer drafter is a poor guesser; the others hit
        if name != "model_1layer":
            assert stats["STAT_generation_spec_accepted"] > 0
    if name.endswith("tight") or name == "spec_geo":
        assert stats["STAT_generation_evictions"] > 0
    if name == "spec_geo":
        assert stats["STAT_generation_prefix_hits"] > 0
        assert stats["STAT_generation_prefix_cow_copies"] > 0
    if name.startswith("two_phase"):
        assert stats["STAT_generation_pad_tokens"] > 0


def test_a_drafter_that_is_the_target_accepts_every_draft(jax_runs):
    stats = jax_runs["model_self"][1]
    assert stats["STAT_generation_spec_accepted"] == \
        stats["STAT_generation_spec_proposed"] > 0


# --------------------------------------------------------------------------
# within the port
# --------------------------------------------------------------------------

def test_two_phase_chunked_and_naive_give_the_same_streams(params):
    reqs = _requests(T, _prompts()[:6], _stochastic)
    two, _, eng = _port(params, reqs, **TWO_PHASE)
    chunked, _, _ = _port(params, reqs, **ROOMY)
    assert two == chunked
    naive = T.NaiveGenerator(TCFG, params, buckets=LADDER,
                             attn_lanes=eng.attn_lanes, device="cpu")
    assert two == {r.request_id: naive.generate(r).tokens for r in reqs}
    assert any(len(set(s)) > 1 for s in two.values())


@pytest.mark.parametrize("draft", ["ngram", "model"])
def test_spec_equals_plain_across_the_four_samplers(params, draft_params,
                                                    draft):
    reqs = _requests(T, _spec_prompts(), _stochastic)
    plain, _, _ = _port(params, reqs, **ROOMY)
    kw = dict(draft="model", draft_cfg=T.DecoderConfig(**DRAFT_KW),
              draft_params=draft_params) if draft == "model" else {}
    spec, stats, _ = _port(params, reqs, spec_tokens=3, **ROOMY, **kw)
    assert spec == plain
    assert stats["STAT_generation_spec_proposed"] > 0


def test_spec_composes_with_prefix_cache_cow_and_preemption(params):
    reqs = _requests(T, _prompts(), _stochastic)
    plain, _, _ = _port(params, reqs, **ROOMY, prefix_cache=False)
    spec, stats, eng = _port(params, reqs, spec_tokens=2, **GEO)
    assert spec == plain
    assert stats["STAT_generation_spec_proposed"] > 0
    for n in ("STAT_generation_prefix_hits",
              "STAT_generation_prefix_cow_copies",
              "STAT_generation_evictions"):
        assert stats[n] > 0, n
    # no dangling references: only the cache's own blocks stay used
    assert not eng.kv._tables
    assert eng.kv.used_blocks == eng.prefix_cache.held_blocks


@pytest.mark.parametrize("draft", ["ngram", "model"])
def test_a_drafter_that_raises_degrades_to_plain_decode(params, monkeypatch,
                                                        draft):
    reqs = _requests(T, _spec_prompts())
    plain, _, _ = _port(params, reqs, **ROOMY)

    def broken(*a, **k):
        raise RuntimeError("drafter down")
    if draft == "ngram":
        monkeypatch.setattr(tengine, "_ngram_propose", broken)
        kw = {}
    else:
        monkeypatch.setattr(T.GenerationEngine, "_run_draft", broken)
        kw = dict(draft="model", draft_cfg=TCFG, draft_params=params)
    spec, stats, eng = _port(params, reqs, spec_tokens=3, **ROOMY, **kw)
    assert spec == plain
    assert stats["STAT_generation_spec_proposed"] == 0
    assert stats["STAT_generation_draft_faults"] > 0
    assert "drafter down" in str(eng.last_draft_fault)


def test_two_phase_launch_pattern_and_warmup(params):
    """On the CPU the paged path log stands in for the launches: a prefill
    runs no paged attention and one layer-norm call a norm (2 layers +
    1); a decode step one paged call a layer."""
    eng = T.GenerationEngine(TCFG, params, device="cpu", **TWO_PHASE)
    report = eng.warmup()
    assert set(report) == {"decode", 8, 16, 32, 64} and eng._warmed
    assert (eng.token_budget, eng.sample_width) == (3, 3)
    tpa.reset_path_log()
    eng.submit(T.GenerationRequest(prompt=[1, 2, 3], max_new_tokens=3))
    n0 = tln.launches
    eng._admit()                       # the prefill alone
    assert tpa.paths_taken() == [] and eng._lane_seq[0].generated
    steps = 0
    while not eng.idle and steps < MAX_STEPS:
        eng.step()
        steps += 1
    assert steps == 2                  # two decode steps; the second retires
    assert tpa.paths_taken() == ["plain"] * (2 * TCFG.layers)
    assert tln.launches == n0          # the CPU counts no kernel launch


def test_spec_budget_and_sample_rows(params):
    eng = T.GenerationEngine(TCFG, params, device="cpu", spec_tokens=3,
                             **ROOMY)
    assert eng.token_budget == 3 * (1 + 3) + 4
    assert eng.sample_width == 3 * 4
    assert set(eng.warmup()) == {"mixed"}
    eng = T.GenerationEngine(TCFG, params, device="cpu", spec_tokens=2,
                             draft="model", draft_cfg=TCFG,
                             draft_params=params, **ROOMY)
    assert set(eng.warmup()) == {"mixed", "draft"}
    assert eng.dk_pools.shape == eng.k_pools.shape
    assert eng.dk_pools.dtype == torch.float32


def test_ngram_proposals_equal_the_reference():
    from paddle_tpu.generation.engine import _ngram_propose as jprop
    rng = np.random.default_rng(3)
    for n in range(1, 40):
        hist = [int(x) for x in rng.integers(0, 4, n)]
        for k in (1, 2, 4):
            assert tengine._ngram_propose(hist, k) == jprop(hist, k)


def test_two_phase_pool_serves_and_preempts(params):
    reqs = _requests(T, _prompts())
    want, _, _ = _port(params, reqs, **TWO_PHASE)
    eng = T.GenerationEngine(TCFG, params, device="cpu",
                             **dict(GEO, prefill_chunk=0,
                                    prefill_buckets=LADDER))
    ev0 = tstat("STAT_generation_evictions")
    with T.GenerationPool(eng) as pool:
        futs = [pool.submit(r) for r in reqs]
        got = {r.request_id: f.result(timeout=120).tokens
               for r, f in zip(reqs, futs)}
    assert got == want
    assert tstat("STAT_generation_evictions") > ev0


# the JAX engine's constructor refusals, raised by both packages
REFUSALS = [
    dict(prefill_chunk=0, prefill_buckets=LADDER, spec_tokens=2),
    dict(prefill_chunk=0, prefill_buckets=LADDER, kv_dtype="int8"),
    dict(prefill_chunk=0, prefill_buckets=LADDER, quant_mode="int8"),
    dict(spec_tokens=2, draft="model"),
    dict(spec_tokens=2, draft="banana"),
    dict(spec_tokens=-1),
    dict(spec_tokens=2, draft="model", draft_cfg="small_vocab"),
    dict(spec_tokens=2, draft="model", draft_cfg="short"),
    dict(quant_mode="int4"),
    dict(kv_dtype="int4"),
    dict(prefill_chunk=-1),
    dict(decode_width=0),
    dict(token_budget=2),
]


@pytest.mark.parametrize("i", range(len(REFUSALS)))
def test_both_engines_refuse_alike(params, i):
    for pkg, cfg in ((J, JCFG), (T, TCFG)):
        kw = dict(ROOMY, **REFUSALS[i])
        dc = kw.get("draft_cfg")
        if dc == "small_vocab":
            kw["draft_cfg"] = pkg.DecoderConfig(**dict(CFG_KW, vocab_size=64))
            kw["draft_params"] = params
        elif dc == "short":
            kw["draft_cfg"] = pkg.DecoderConfig(**dict(CFG_KW,
                                                       max_seq_len=32))
            kw["draft_params"] = params
        if pkg is T:
            kw["device"] = "cpu"
        with pytest.raises(ValueError):
            pkg.GenerationEngine(cfg, params, **kw)


def test_submit_refuses_a_prompt_past_the_ladder(params):
    for pkg, cfg, extra in ((J, JCFG, {}), (T, TCFG, {"device": "cpu"})):
        eng = pkg.GenerationEngine(cfg, params, **dict(
            TWO_PHASE, prefill_buckets="4,8"), **extra)
        with pytest.raises(ValueError, match="ladder"):
            eng.submit(pkg.GenerationRequest(prompt=[1] * 9,
                                             max_new_tokens=2))
        assert eng.idle
