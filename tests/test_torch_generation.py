"""The port's generation engine against the JAX package's, on the CPU.

Model, sampler, KV-cache ledger, engine and pool: the same numpy weights
and requests go through both packages (the JAX engine with its default
"reference" attention, the port with its plain versions) at a small size,
and within the port the paged engine is held against the naive
full-recompute generator. Stochastic samples cannot match across the
packages (threefry against Philox), so across packages the token streams
compared are greedy; the port's own sampling contract (a pure function of
logits, seed and step) is held within the port.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.generation as J
from paddle_tpu.generation import kv_cache as jkv
from paddle_tpu.generation import model as jmodel
from paddle_tpu.generation import sampling as jsampling
from paddle_tpu.monitor import stat_get as jstat
import paddle_tpu_torch.generation as T
from paddle_tpu_torch.generation import engine as tengine
from paddle_tpu_torch.generation import kv_cache as tkv
from paddle_tpu_torch.generation import sampling as tsampling
from paddle_tpu_torch.jit import load_reference_params
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.monitor import stat_get as tstat
from paddle_tpu_torch.serving import ServingQueueFull

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)

CFG_KW = dict(vocab_size=128, hidden=64, layers=2, heads=4, max_seq_len=64)
JCFG, TCFG = J.DecoderConfig(**CFG_KW), T.DecoderConfig(**CFG_KW)
# logits: 2 layers of fp32 in other orders, values O(1): ~2e-6 measured.
# K/V rows: the second layer's come after a whole first layer summed in
# another order, values O(1): up to 1.9e-6 measured.
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
POOL_TOL = dict(atol=4e-6, rtol=1e-6)
# an engine geometry whose run below has prefix hits, copy-on-write and
# preemption: 3 lanes, 4-token chunks, a pool of 17 usable 4-token blocks
GEO = dict(num_blocks=18, block_size=4, decode_width=3, prefill_chunk=4)
STATS = ("STAT_generation_prefills", "STAT_generation_tokens",
         "STAT_generation_prefix_hits", "STAT_generation_prefix_misses",
         "STAT_generation_prefix_cow_copies", "STAT_generation_evictions",
         "STAT_generation_pad_tokens")


@pytest.fixture(scope="module")
def params():
    return T.init_params(TCFG, seed=0)


@pytest.fixture(scope="module")
def tparams(params):
    return load_reference_params(TCFG, params, "cpu")


def _prompts():
    """Two prompts sharing a 10-token prefix, a short one, two more on the
    prefix (admitted once it is published: cache hits), then long ones
    that run the pool dry (preemption)."""
    rng = np.random.default_rng(1)

    def draw(n):
        return [int(x) for x in rng.integers(0, 128, n)]
    shared = draw(10)
    return [shared + draw(3), shared + draw(9), [1, 2, 3, 4, 5],
            shared + draw(1), shared + draw(6), draw(30), draw(21),
            draw(14), draw(1)]


def _requests(pkg, sampling=None):
    return [pkg.GenerationRequest(
        prompt=p, max_new_tokens=12 + i % 7, request_id=i,
        sampling=sampling(pkg, i) if sampling else pkg.SamplingParams())
        for i, p in enumerate(_prompts())]


def _streams(results):
    return {r.request_id: r.tokens for r in results}


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------

def test_init_params_bit_for_bit(params):
    ref = jmodel.init_params(JCFG, seed=0)
    assert list(ref) == list(params)
    for name, a in ref.items():
        assert params[name].dtype == np.float32
        np.testing.assert_array_equal(params[name].view(np.uint32),
                                      np.asarray(a).view(np.uint32))


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_load_reference_params_raises_on_a_wrong_name(params, fault):
    bad = dict(params)
    if fault == "missing":
        del bad["l1_w2"]
    elif fault == "extra":
        bad["l9_w1"] = bad["l1_w1"]
    else:
        bad["pos_emb"] = bad["pos_emb"][:-1]
    with pytest.raises(KeyError if fault != "shape" else ValueError,
                       match="load_reference_params"):
        load_reference_params(TCFG, bad, "cpu")


def test_load_reference_params_copies_every_tensor(params, tparams):
    assert set(tparams) == set(params)
    for name, t in tparams.items():
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), params[name])


def test_forward_full_matches_reference(params, tparams):
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 128, (3, 20)).astype(np.int32)
    lens = np.asarray([20, 7, 1], np.int32)
    jl, jk, jv = jmodel.forward_full(
        JCFG, {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(toks), jnp.asarray(lens), attn_lanes=32)
    tl, tk, tv = T.forward_full(TCFG, tparams, torch.from_numpy(toks),
                                torch.from_numpy(lens), attn_lanes=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **POOL_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **POOL_TOL)


def _mixed_steps():
    """Three mixed steps of 6 slots: a 5-token chunk of one sequence
    (crossing blocks) and a decode single of another, then idle slots."""
    t, m = 7, 16
    tables = np.zeros((t, m), np.int32)
    pos = np.zeros(t, np.int32)
    tok = np.zeros(t, np.int32)
    tables[:5, :4] = [1, 2, 3, 6]
    tables[5, :2] = [4, 5]
    out = []
    for step in range(3):
        pos[:5] = np.arange(5) + 5 * step
        tok[:5] = np.arange(5) + 5 * step + 7
        pos[5], tok[5] = step, 11 + step
        out.append((tables.copy(), pos.copy(), tok.copy()))
    return out


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_forward_paged_matches_reference_logits_and_pools(params, tparams,
                                                          kv):
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    shape = (2, 16, 4, 4, 16)
    if kv == "fp32":
        jpools = [jnp.zeros(shape, jnp.float32)] * 2
        tpools = [torch.zeros(shape), torch.zeros(shape)]
        jsc, tsc = [None, None], [None, None]
    else:
        jpools = [jnp.zeros(shape, jnp.int8)] * 2
        tpools = [torch.zeros(shape, dtype=torch.int8) for _ in range(2)]
        jsc = [jnp.ones(shape[:-1], jnp.float32)] * 2
        tsc = [torch.ones(shape[:-1]) for _ in range(2)]
    for tables, pos, tok in _mixed_steps():
        out = jmodel.forward_paged(JCFG, jp, *jpools, jnp.asarray(tables),
                                   jnp.asarray(pos), jnp.asarray(tok),
                                   k_scale_pools=jsc[0], v_scale_pools=jsc[1])
        jl, jpools = out[0], list(out[1:3])
        if kv != "fp32":
            jsc = list(out[3:5])
        tl = T.forward_paged(TCFG, tparams, *tpools, torch.from_numpy(tables),
                             torch.from_numpy(pos), torch.from_numpy(tok),
                             k_scale_pools=tsc[0], v_scale_pools=tsc[1])
        # rows of the trash block (block 0) are written by several idle
        # slots in no fixed order: compare the real blocks
        np.testing.assert_allclose(tl.numpy()[:6], np.asarray(jl)[:6],
                                   **LOGIT_TOL)
        for jpool, tpool in zip(jpools, tpools):
            np.testing.assert_allclose(tpool[:, 1:].float().numpy(),
                                       np.asarray(jpool[:, 1:], np.float32),
                                       **POOL_TOL)
        if kv != "fp32":
            for js, ts in zip(jsc, tsc):
                np.testing.assert_allclose(ts[:, 1:].numpy(),
                                           np.asarray(js[:, 1:]), **POOL_TOL)


def test_forward_paged_matches_full_recompute(tparams):
    """Within the port: a prompt streamed in 5-token chunks gives, at every
    position, the logits of forward_full over the prefix."""
    shape = (2, 16, 4, 4, 16)
    pools = [torch.zeros(shape), torch.zeros(shape)]
    seq = []
    for tables, pos, tok in _mixed_steps():
        logits = T.forward_paged(TCFG, tparams, *pools,
                                 torch.from_numpy(tables),
                                 torch.from_numpy(pos), torch.from_numpy(tok))
        for j in range(5):
            seq.append(int(tok[j]))
            full = T.forward_full(TCFG, tparams, torch.tensor([seq]),
                                  torch.tensor([len(seq)]), attn_lanes=64)[0]
            np.testing.assert_allclose(logits[j].numpy(), full[0].numpy(),
                                       **LOGIT_TOL)


# --------------------------------------------------------------------------
# sampling
# --------------------------------------------------------------------------

def _logits(b, v, seed, scale=1.0):
    return (np.random.default_rng(seed).random((b, v)) * scale
            ).astype(np.float32)


def test_greedy_equals_reference():
    x = _logits(6, 40, 0, scale=5.0)
    z = np.zeros(6)
    want = np.asarray(jsampling.sample_tokens(
        jnp.asarray(x), jnp.asarray(z, jnp.float32), jnp.asarray(z, jnp.int32),
        jnp.ones(6, jnp.float32), jnp.asarray(z, jnp.int32),
        jnp.asarray(z, jnp.int32)))
    got = tsampling.sample_tokens(torch.from_numpy(x), z, z, np.ones(6), z, z)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.5), (6, 0.6),
                                         (1, 1.0), (0, 0.05)])
def test_top_k_top_p_keep_sets_equal_the_reference(top_k, top_p):
    """The reference's keep set is the support of its sampler: 400 draws
    at temperature 1 over 16 tokens of probability >= 1/40 each miss a
    kept token with probability < 1e-4."""
    v, draws = 16, 400
    x = _logits(1, v, 3, scale=0.9)
    rows = np.repeat(x, draws, axis=0)
    seeds = np.arange(draws, dtype=np.int32)
    ref = np.asarray(jsampling.sample_tokens(
        jnp.asarray(rows), jnp.ones(draws, jnp.float32),
        jnp.full(draws, top_k, jnp.int32), jnp.full(draws, top_p, jnp.float32),
        jnp.asarray(seeds), jnp.zeros(draws, jnp.int32)))
    filtered = tsampling.filter_logits(
        torch.from_numpy(x), torch.ones(1), torch.tensor([top_k]),
        torch.tensor([top_p]))
    keep = set(np.flatnonzero(filtered[0].numpy() > -1e29))
    assert keep == set(ref.tolist())


def test_a_sample_is_a_pure_function_of_logits_seed_and_step():
    x = _logits(8, 50, 4, scale=4.0)
    temps = np.full(8, 0.8)
    temps[2] = 0.0
    tks = np.asarray([0, 40, 0, 5, 0, 3, 10, 0])
    tps = np.asarray([1.0, 1.0, 1.0, 0.9, 0.7, 1.0, 0.95, 0.5])
    seeds = np.arange(8) * 7 + 1
    steps = np.arange(8) + 3
    batch = tsampling.sample_tokens(torch.from_numpy(x), temps, tks, tps,
                                    seeds, steps)
    again = tsampling.sample_tokens(torch.from_numpy(x), temps, tks, tps,
                                    seeds, steps)
    assert torch.equal(batch, again)
    for i in range(8):
        one = tsampling.sample_tokens(torch.from_numpy(x[i:i + 1]),
                                      temps[i:i + 1], tks[i:i + 1],
                                      tps[i:i + 1], seeds[i:i + 1],
                                      steps[i:i + 1])
        assert int(one[0]) == int(batch[i])
    assert int(batch[2]) == int(np.argmax(x[2]))
    moved = tsampling.sample_tokens(torch.from_numpy(x), temps, tks, tps,
                                    seeds, steps + 1)
    assert not torch.equal(moved, batch)


def test_temperature_sampling_follows_softmax():
    """Chi-square of 8000 draws (seeds 0..7999, step 5) against
    softmax(logits / T): 7 degrees of freedom, 24.3 is p = 0.001."""
    v, n, temp = 8, 8000, 0.7
    x = np.asarray([[1.0, 0.2, -0.5, 2.0, 0.0, 1.5, -1.0, 0.7]], np.float32)
    toks = tsampling.sample_tokens(
        torch.from_numpy(np.repeat(x, n, axis=0)), np.full(n, temp),
        np.zeros(n, np.int64), np.ones(n), np.arange(n), np.full(n, 5))
    counts = np.bincount(toks.numpy(), minlength=v)
    p = np.exp(x[0] / temp) / np.exp(x[0] / temp).sum()
    chi2 = float((((counts - n * p) ** 2) / (n * p)).sum())
    assert chi2 < 24.3, (chi2, counts, n * p)


def test_sampling_params_validation():
    with pytest.raises(ValueError):
        T.SamplingParams(top_k=-1)
    with pytest.raises(ValueError):
        T.SamplingParams(top_p=0.0)


# --------------------------------------------------------------------------
# KV cache
# --------------------------------------------------------------------------

def _ledger_script(mod):
    """One scripted life of a pool and prefix cache; returns a snapshot
    (tables, refcounts, free count, stats of the calls) after each op."""
    kv = mod.KVCacheManager(12, 4)
    pc = mod.PrefixCache(kv, 4)
    snaps = []

    def snap(tag, value=None):
        snaps.append((tag, value, {s: kv.owned(s) for s in ("a", "b", "c")
                                   if s in kv._tables},
                      {b: kv.refcount(b) for b in range(12)},
                      kv.free_blocks, pc.entries, pc.held_blocks))
    prompt = list(range(10))
    snap("alloc", kv.alloc("a", 3))
    keys = pc.keys_for(prompt)
    for tokens_b, key in keys[:2]:
        pc.insert(key, tokens_b, kv.owned("a")[:kv.blocks_for_tokens(
            tokens_b)])
    snap("insert")
    hit = pc.match(prompt[:9] + [77])
    snap("match", hit)
    snap("attach", kv.attach("b", hit[1], 2))
    snap("extend", kv.extend("b"))
    snap("cow", kv.cow("b", 1))
    snap("free a", kv.free("a"))
    snap("alloc c", kv.alloc("c", 4))
    with pytest.raises(mod.BlockPoolExhausted):
        kv.alloc("d", 9)
    snap("exhausted")
    snap("evict_for", pc.evict_for(6))
    snap("evict b", kv.evict("b"))
    snap("free twice", kv.free("b"))
    pc.clear()
    snap("clear")
    return snaps


def test_kv_cache_ledger_matches_reference():
    assert _ledger_script(tkv) == _ledger_script(jkv)
    assert tkv.TRASH_BLOCK == jkv.TRASH_BLOCK == 0


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_greedy_streams_and_stats_equal_the_jax_engine(params, kv):
    j0 = {n: jstat(n) for n in STATS}
    jres = J.GenerationEngine(JCFG, params, kv_dtype=kv, **GEO).generate(
        _requests(J))
    jd = {n: jstat(n) - j0[n] for n in STATS}
    t0 = {n: tstat(n) for n in STATS}
    eng = T.GenerationEngine(TCFG, params, kv_dtype=kv, device="cpu", **GEO)
    tres = eng.generate(_requests(T))
    td = {n: tstat(n) - t0[n] for n in STATS}
    assert _streams(tres) == _streams(jres)
    assert td == jd
    # the run exercised what it is meant to
    assert td["STAT_generation_prefix_hits"] > 0
    assert td["STAT_generation_prefix_cow_copies"] > 0
    assert td["STAT_generation_evictions"] > 0
    assert (eng.k_pools.dtype == torch.int8) == (kv == "int8")
    assert all(r.evictions >= 0 for r in tres)


def test_engine_equals_naive_generator(params):
    eng = T.GenerationEngine(TCFG, params, device="cpu", **GEO)
    reqs = _requests(T)[:5]
    got = _streams(eng.generate(reqs))
    naive = T.NaiveGenerator(TCFG, params, attn_lanes=eng.attn_lanes,
                             device="cpu")
    assert got == {r.request_id: naive.generate(r).tokens for r in reqs}


def _stochastic(pkg, i):
    return pkg.SamplingParams(temperature=0.9, top_k=(0, 20)[i % 2],
                              top_p=(1.0, 0.9)[i % 3 == 0], seed=100 + i)


def test_stochastic_streams_survive_eviction_and_batch_changes(params):
    """Eviction replay and batch independence: the same stochastic
    requests in a roomy pool one lane at a time, three lanes at a time,
    and in the tight pool that preempts, give the same streams."""
    runs = []
    ev0 = tstat("STAT_generation_evictions")
    for geo in (dict(GEO, num_blocks=64, decode_width=1),
                dict(GEO, num_blocks=64), GEO):
        eng = T.GenerationEngine(TCFG, params, device="cpu", **geo)
        runs.append(_streams(eng.generate(_requests(T, _stochastic))))
    assert tstat("STAT_generation_evictions") > ev0
    assert runs[0] == runs[1] == runs[2]
    assert any(len(set(s)) > 1 for s in runs[0].values())


def test_eos_ends_a_stream(params):
    eng = T.GenerationEngine(TCFG, params, device="cpu", **GEO)
    first = eng.generate([T.GenerationRequest(prompt=[3, 4, 5],
                                              max_new_tokens=6)])[0]
    eos = first.tokens[2]
    res = eng.generate([T.GenerationRequest(prompt=[3, 4, 5],
                                            max_new_tokens=6,
                                            eos_token=eos)])[0]
    assert res.finish_reason == "eos"
    assert res.tokens == first.tokens[:first.tokens.index(eos)]


def test_submit_validation_is_per_request(params):
    eng = T.GenerationEngine(TCFG, params, device="cpu", **GEO)
    for bad in (T.GenerationRequest(prompt=[]),
                T.GenerationRequest(prompt=[1] * 60, max_new_tokens=10),
                T.GenerationRequest(prompt=[1], max_new_tokens=0),
                T.GenerationRequest(prompt=[128])):
        with pytest.raises(ValueError):
            eng.submit(bad)
    assert eng.idle


@pytest.mark.parametrize("kw", [dict(autotune=True),
                                dict(program_cache_dir="x"),
                                dict(kernel="pallas")])
def test_options_left_out_raise_naming_the_roadmap(params, kw, tmp_path,
                                                   monkeypatch):
    """These options raised naming ROADMAP.md A5 while the queue held them;
    each is now taken on the CPU (tests/test_torch_autotune.py holds them
    against the JAX engine), and the one form still refused, the plain
    paged attention on the card, raises naming the port's rule."""
    monkeypatch.chdir(tmp_path)
    eng = T.GenerationEngine(TCFG, params, device="cpu", **dict(GEO, **kw))
    # the tune varies geometry only: every form is the Hopper kernel's
    assert eng.kernel == "pallas" and not os.listdir(tmp_path)
    if kw.get("autotune"):
        assert {c["kernel"] for c in eng._policy_entry["candidates"]} == \
            {"pallas"}
    with pytest.raises(ValueError, match="ROADMAP.md"):
        tengine.check_kernel("reference", torch.device("cuda", 0))


def test_engine_runs_on_the_card_unless_asked_for_the_cpu(params,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.GenerationEngine(TCFG, params, **GEO)


def test_pool_geometry_and_cpu_path(params):
    e32 = T.GenerationEngine(TCFG, params, device="cpu", **GEO)
    e8 = T.GenerationEngine(TCFG, params, device="cpu", kv_dtype="int8",
                            **GEO)
    assert e32.token_budget == 3 + 4 and e32.kv_dtype == "fp32"
    assert e8.k_scales is not None and bool((e8.k_scales == 1).all())
    assert e8.kv_bytes_per_seq() * 2 <= e32.kv_bytes_per_seq()
    assert e8.kv_pool_bytes() * 2 <= e32.kv_pool_bytes()
    assert e32.kv_capacity_seqs() == 17 // 16
    tpa.reset_path_log()
    e32.warmup()
    assert set(tpa.paths_taken()) == {"plain"}
    assert len(tpa.paths_taken()) == TCFG.layers


# --------------------------------------------------------------------------
# pool
# --------------------------------------------------------------------------

def test_pool_concurrent_submitters_each_get_their_answer(params):
    eng = T.GenerationEngine(TCFG, params, device="cpu", **GEO)
    reqs = _requests(T)[:6]
    want = _streams(T.GenerationEngine(TCFG, params, device="cpu",
                                       **GEO).generate(reqs))
    got, errors = {}, []

    def client(r):
        try:
            got[r.request_id] = pool.submit(r).result(timeout=120).tokens
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
    with T.GenerationPool(eng) as pool:
        threads = [threading.Thread(target=client, args=(r,)) for r in reqs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    assert not errors
    assert got == want


def test_pool_backpressure_raises_queue_full(params):
    eng = T.GenerationEngine(TCFG, params, device="cpu", **GEO)
    pool = T.GenerationPool(eng, queue_depth=1, _start=False)
    r0 = tstat("STAT_generation_rejected")
    pool.submit(T.GenerationRequest(prompt=[1, 2]))
    with pytest.raises(ServingQueueFull) as info:
        pool.submit(T.GenerationRequest(prompt=[3, 4]), timeout=0.05)
    assert info.value.queue_depth == 1
    assert tstat("STAT_generation_rejected") == r0 + 1
    pool.start()
    pool.close()


def test_pool_isolates_a_bad_request(params):
    eng = T.GenerationEngine(TCFG, params, device="cpu", **GEO)
    with T.GenerationPool(eng) as pool:
        good = pool.submit(T.GenerationRequest(prompt=[1, 2, 3],
                                               max_new_tokens=4))
        bad = pool.submit(T.GenerationRequest(prompt=[1] * 70))
        good2 = pool.submit(T.GenerationRequest(prompt=[4, 5],
                                                max_new_tokens=3))
        with pytest.raises(ValueError, match="max_seq_len"):
            bad.result(timeout=60)
        assert len(good.result(timeout=60).tokens) == 4
        assert len(good2.result(timeout=60).tokens) == 3


def test_pool_close_drains(params):
    eng = T.GenerationEngine(TCFG, params, device="cpu", **GEO)
    pool = T.GenerationPool(eng)
    futs = [pool.submit(r) for r in _requests(T)[:4]]
    pool.close()
    assert all(f.done() for f in futs)
    assert [len(f.result().tokens) for f in futs] == [12, 13, 14, 15]
    with pytest.raises(RuntimeError, match="closed"):
        pool.submit(T.GenerationRequest(prompt=[1]))


def test_pool_restarts_after_a_step_fault(params, monkeypatch):
    """A step failure fails the in-flight futures with PoolRestarted, the
    engine's sequence state is rebuilt, and the next request is served."""
    from paddle_tpu_torch.serving import PoolRestarted
    eng = T.GenerationEngine(TCFG, params, device="cpu", **GEO)
    eng.warmup()
    real = eng._run_mixed
    calls = []

    def flaky(*a):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected step fault")
        return real(*a)
    monkeypatch.setattr(eng, "_run_mixed", flaky)
    with T.GenerationPool(eng) as pool:
        doomed = pool.submit(T.GenerationRequest(prompt=[1, 2, 3],
                                                 max_new_tokens=5))
        with pytest.raises(PoolRestarted) as info:
            doomed.result(timeout=60)
        assert "injected" in str(info.value.cause)
        deadline = time.monotonic() + 30
        while not pool._healthy and time.monotonic() < deadline:
            time.sleep(0.01)
        ok = pool.submit(T.GenerationRequest(prompt=[1, 2, 3],
                                             max_new_tokens=5))
        assert len(ok.result(timeout=60).tokens) == 5
    # the fault's blocks came back; the prefix cache keeps what it published
    assert eng.kv.free_blocks + eng.prefix_cache.held_blocks == \
        GEO["num_blocks"] - 1


def test_chip_smoke_needs_a_card(tmp_path):
    """Without CUDA the chip smoke exits nonzero and prints no result,
    from the checkout and from a directory holding only the script."""
    import shutil
    import subprocess
    import sys
    from pathlib import Path
    script = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(script, alone)
    for path in (script, alone):
        proc = subprocess.run([sys.executable, str(path)],
                              capture_output=True, text=True, timeout=120,
                              cwd=path.parent,
                              env={"CUDA_VISIBLE_DEVICES": "",
                                   "PATH": "/usr/bin:/bin"})
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_pool_sheds_a_request_whose_deadline_burns_in_the_queue(params):
    from paddle_tpu_torch.serving import DeadlineBurned
    eng = T.GenerationEngine(TCFG, params, device="cpu", **GEO)
    pool = T.GenerationPool(eng, queue_depth=1, _start=False)
    s0 = tstat("STAT_generation_shed_at_admit")
    first = pool.submit(T.GenerationRequest(prompt=[1, 2], max_new_tokens=2))
    with pytest.raises(DeadlineBurned):
        pool.submit(T.GenerationRequest(prompt=[3, 4]), deadline=0.05)
    assert tstat("STAT_generation_shed_at_admit") == s0 + 1
    pool.start()
    pool.close()
    assert len(first.result(timeout=10).tokens) == 2


def test_flags_set_the_engine_geometry(params):
    from paddle_tpu_torch import flags
    keys = ("FLAGS_generation_decode_width", "FLAGS_generation_kv_quant",
            "FLAGS_generation_prefill_chunk")
    before = {k: flags.get_flag(k) for k in keys}
    try:
        flags.set_flags({"generation_decode_width": 2,
                         "FLAGS_generation_kv_quant": "int8",
                         "FLAGS_generation_prefill_chunk": 4})
        eng = T.GenerationEngine(TCFG, params, device="cpu", num_blocks=18,
                                 block_size=4)
        assert (eng.decode_width, eng.kv_dtype, eng.token_budget) == \
            (2, "int8", 6)
        with pytest.raises(ValueError, match="unknown flag"):
            flags.set_flags({"FLAGS_no_such_flag": 1})
    finally:
        flags.set_flags(before)
    assert T.GenerationEngine(TCFG, params, device="cpu").kv_dtype == "fp32"
