"""The port's adaptive dispatch against the JAX package's, on the CPU.

A 2-layer decoder of hidden 64 (numpy weights from the JAX package's
``init_params``): at a pinned geometry the port's greedy streams equal the
JAX engine's; a tune keeps only a form whose streams are bitwise the
default form's, stores the winner in the policy layer, and a fresh engine
reloads it with no trial; pins (arguments, explicitly set flags) are
respected and a flag's default is not a pin; damaged policy files tune
again; the engine publishes its gauges and the scheduler's
``_reset_engine`` retracts them. The deliberate difference: the kernel
form has one member (the Hopper kernel), so only geometry is searched,
``kernel="reference"`` is its alias on the CPU and raises on a CUDA
device. The
Predictor's bucket-or-exact choice tunes once, then is one lookup.
"""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu.generation as J

import paddle_tpu_torch as tpt
import paddle_tpu_torch.generation as T
from paddle_tpu_torch import autotune
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import inference as TI
from paddle_tpu_torch.autotune import CandidateForm, generation_candidates
from paddle_tpu_torch.core import program_cache
from paddle_tpu_torch.generation.engine import check_kernel
from paddle_tpu_torch.monitor import gauge_get, gauge_set, stat_get

torch.set_num_threads(1)

CFG_KW = dict(vocab_size=64, hidden=64, layers=2, heads=4, max_seq_len=32)
JCFG, TCFG = J.DecoderConfig(**CFG_KW), T.DecoderConfig(**CFG_KW)
GEO = dict(num_blocks=48, decode_width=2)


@pytest.fixture(scope="module")
def params():
    return J.init_params(JCFG, seed=0)


@pytest.fixture(autouse=True)
def _clean_slate():
    """A small search and probe, a fresh policy table, flags restored."""
    saved, saved_exp = dict(tflags._values), set(tflags._EXPLICIT)
    tflags.set_flags({"FLAGS_autotune_candidates": 3,
                      "FLAGS_autotune_probe_tokens": 8})
    tflags.clear_explicit()
    autotune.reset()
    yield
    tflags._values.clear()
    tflags._values.update(saved)
    tflags._EXPLICIT.clear()
    tflags._EXPLICIT.update(saved_exp)
    autotune.reset()


def _engine(params, **kw):
    kw = dict(GEO, **kw)
    kw.setdefault("kernel", "pallas")
    kw.setdefault("block_size", 4)
    kw.setdefault("autotune", True)
    return T.GenerationEngine(TCFG, params, device="cpu", **kw)


def _streams(pkg, eng, temperature=0.8, n=3, new=5, seed=7):
    rng = np.random.default_rng(seed)
    for i in range(n):
        prompt = [int(t) for t in rng.integers(0, 64, 3 + 4 * i)]
        eng.submit(pkg.GenerationRequest(
            prompt=prompt, max_new_tokens=new,
            sampling=pkg.SamplingParams(temperature=temperature, top_k=5,
                                        seed=100 + i),
            request_id="r%d" % i))
    out = {}
    for _ in range(200):
        if eng.idle:
            break
        for r in eng.step():
            out[r.request_id] = tuple(r.tokens)
    assert eng.idle
    return out


def test_pinned_geometry_streams_equal_the_jax_engines(params):
    geo = dict(GEO, block_size=4, prefill_chunk=4, token_budget=0)
    jeng = J.GenerationEngine(JCFG, params, kernel="reference",
                              autotune=False, **geo)
    teng = T.GenerationEngine(TCFG, params, kernel="pallas", autotune=False,
                              device="cpu", **geo)
    assert teng.kernel == "pallas" and teng._policy_entry is None
    want = _streams(J, jeng, temperature=0.0)
    assert _streams(T, teng, temperature=0.0) == want


def _policy_files(cache):
    return sorted(Path(cache, "policy").glob("*.json"))


def test_the_winner_equals_the_reference_form_and_reloads_with_no_trial(
        params, tmp_path):
    cache = str(tmp_path / "cache")
    t0 = stat_get("STAT_autotune_trials")
    eng = _engine(params, program_cache_dir=cache)   # the chunk is free
    entry = eng._policy_entry
    assert entry["source"] == "tuned" and entry["trials"] == 3
    assert stat_get("STAT_autotune_trials") == t0 + 3
    assert [c["prefill_chunk"] for c in entry["candidates"]] == [8, 32, 16]
    assert entry["candidates"][0]["eligible"]
    assert {c["label"]: c["eligible"] for c in entry["candidates"]}[
        entry["label"]]
    assert eng.prefill_chunk == entry["prefill_chunk"]
    assert len(_policy_files(cache)) == 1
    # the gate: the winner decodes the default form's streams
    ref = _engine(params, autotune=False, prefill_chunk=8)
    assert _streams(T, eng) == _streams(T, ref)
    # a fresh engine reloads the winner: no trial, one cache hit
    autotune.reset()
    t1, h1 = stat_get("STAT_autotune_trials"), \
        stat_get("STAT_autotune_cache_hits")
    again = _engine(params, program_cache_dir=cache)
    assert stat_get("STAT_autotune_trials") == t1
    assert stat_get("STAT_autotune_cache_hits") == h1 + 1
    assert again._policy_entry["source"] == "disk"
    assert again._policy_entry["label"] == entry["label"]


def test_a_stream_that_differs_never_wins():
    """The Predictor's two-form tuner: a faster form whose value is not
    bitwise the reference's is not eligible."""
    slow = lambda: [np.ones(3, np.float32)]  # noqa: E731
    fast_wrong = lambda: [np.full(3, 1.0000001, np.float32)]  # noqa: E731
    f0 = stat_get("STAT_autotune_fallbacks")
    entry = autotune.tune_two_forms(
        {"kind": "test"}, program_cache_dir="", reference="bucket",
        forms={"bucket": slow, "exact": fast_wrong},
        compare=TI._bitwise_rows)
    assert entry["form"] == "bucket"
    assert [c["eligible"] for c in entry["candidates"]] == [True, False]
    assert stat_get("STAT_autotune_fallbacks") == f0 + 1
    assert autotune.policy().resolve(autotune.key_for({"kind": "test"})) \
        == entry


def test_pins_are_respected_and_a_default_is_not_a_pin(params):
    d = CandidateForm("pallas", 16, 8, 0)
    free = generation_candidates(d, {}, budget=10)
    assert free[0] == d and {c.kernel for c in free} == {"pallas"}
    assert {c.block_size for c in free} == {16, 32, 8}
    pinned = generation_candidates(d, {"block_size": 16, "kernel": "pallas"},
                                   budget=10)
    assert {(c.block_size, c.kernel) for c in pinned} == {(16, "pallas")}
    # an explicitly set flag pins its knob; the tune varies the rest
    tflags.set_flags({"FLAGS_generation_block_size": 8})
    eng = _engine(params, block_size=None, kernel=None, prefill_chunk=4)
    assert eng.kv.block_size == 8 and eng.prefill_chunk == 4
    assert {c["block_size"] for c in eng._policy_entry["candidates"]} == {8}
    assert {c["kernel"] for c in eng._policy_entry["candidates"]} == \
        {"pallas"}
    # every knob pinned: nothing to tune
    t0 = stat_get("STAT_autotune_trials")
    eng = _engine(params, prefill_chunk=4, token_budget=0)
    assert eng._policy_entry is None and \
        stat_get("STAT_autotune_trials") == t0


def test_the_card_searches_geometry_only(monkeypatch):
    """The deliberate difference from the JAX package: the kernel form
    has one member, the Hopper kernel; "reference" is its alias on the
    CPU and is never a candidate."""
    d = CandidateForm("pallas", 16, 8, 0)
    card = generation_candidates(d, {}, budget=10)
    assert {c.kernel for c in card} == {"pallas"} and len(card) == 6
    alias = generation_candidates(d._replace(kernel="reference"), {}, 10)
    assert {c.kernel for c in alias} == {"reference"} and len(alias) == 6
    with pytest.raises(ValueError, match="never runs on a CUDA tensor"):
        check_kernel("reference", torch.device("cuda", 0))
    check_kernel("reference", torch.device("cpu"))
    check_kernel("pallas", torch.device("cuda", 0))
    with pytest.raises(ValueError, match="unknown paged-attention kernel"):
        check_kernel("tpu", torch.device("cpu"))
    # without a card the engine's device raises first
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.GenerationEngine(TCFG, {}, kernel="reference", device="cuda")


@pytest.mark.parametrize("how", ["corrupt", "skewed"])
def test_damaged_policy_files_tune_again(params, tmp_path, how):
    cache = str(tmp_path / "cache")
    eng = _engine(params, program_cache_dir=cache, prefill_chunk=4,
                  token_budget=None, kernel=None)
    path, = _policy_files(cache)
    blob = path.read_bytes()
    if how == "corrupt":
        path.write_bytes(blob[:-7] + b"garbage")
    else:
        nl = blob.index(b"\n", len(program_cache.POLICY_MAGIC))
        hdr = json.loads(blob[len(program_cache.POLICY_MAGIC):nl])
        hdr["format"] = program_cache.POLICY_FORMAT_VERSION + 1
        path.write_bytes(program_cache.POLICY_MAGIC +
                         json.dumps(hdr).encode() + blob[nl:])
    autotune.reset()
    c0, t0 = stat_get("STAT_program_cache_corrupt"), \
        stat_get("STAT_autotune_trials")
    again = _engine(params, program_cache_dir=cache, prefill_chunk=4,
                    token_budget=None, kernel=None)
    assert stat_get("STAT_program_cache_corrupt") == c0 + 1
    assert stat_get("STAT_autotune_trials") > t0
    assert again._policy_entry["source"] == "tuned"
    assert again._policy_entry["trials"] == eng._policy_entry["trials"]
    assert program_cache.load_policy(cache, path.stem) is not None


def test_engine_publishes_and_reset_engine_retracts_gauges(params):
    _engine(params, prefill_chunk=4, block_size=None, token_budget=None,
            kernel=None)
    assert gauge_get("GAUGE_autotune_active") == 1
    assert gauge_get("GAUGE_autotune_trials") >= 2
    plain = _engine(params, autotune=False, prefill_chunk=4)
    pool = T.GenerationPool(plain, _start=False)
    try:
        gauge_set("GAUGE_autotune_active", 1)
        gauge_set("GAUGE_autotune_step_time_us", 123.0)
        gauge_set("GAUGE_autotune_trials", 9)
        pool._reset_engine()
        assert gauge_get("GAUGE_autotune_active") == 0
        assert gauge_get("GAUGE_autotune_step_time_us") == 0
        assert gauge_get("GAUGE_autotune_trials") == 0
    finally:
        pool.close()


@pytest.fixture(scope="module")
def mlp_bundle(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mlp"))
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", [6])
        y = tpt.layers.fc(tpt.layers.fc(x, 16, act="relu"), 3)
    exe, scope = tpt.Executor("cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    tpt.save_inference_model(d, ["x"], [y], exe, main_program=main,
                             scope=scope)
    return d


def test_predictor_bucket_dispatch_tunes_then_one_lookup(mlp_bundle,
                                                         tmp_path):
    cfg = TI.Config(mlp_bundle)
    cfg.disable_gpu()
    cfg.switch_shape_bucketing(True, buckets=[1, 2, 4, 8])
    cfg.switch_autotune(True)
    cfg.enable_program_cache(str(tmp_path / "cache"))
    p = TI.create_predictor(cfg)
    feed = np.random.default_rng(0).standard_normal((3, 6)).astype(
        np.float32)
    t0 = stat_get("STAT_autotune_trials")
    out1, = p.run([feed])
    assert stat_get("STAT_autotune_trials") == t0 + 6
    snap = [s for s in autotune.policies() if s["kind"] == "predictor"]
    assert snap and snap[0]["form"] in ("bucket", "exact")
    assert snap[0]["rows"] == 3 and snap[0]["bucket"] == 4 and \
        snap[0]["backend"] == "cpu"
    t1, h1 = stat_get("STAT_autotune_trials"), \
        stat_get("STAT_autotune_cache_hits")
    out2, = p.run([feed])
    assert stat_get("STAT_autotune_trials") == t1
    assert stat_get("STAT_autotune_cache_hits") == h1 + 1
    assert out1.tobytes() == out2.tobytes()
    autotune.reset()
    p2 = TI.create_predictor(cfg)
    out3, = p2.run([feed])
    assert stat_get("STAT_autotune_trials") == t1
    assert out3.tobytes() == out1.tobytes()
    off = TI.Config(mlp_bundle)
    off.disable_gpu()
    off.switch_shape_bucketing(True, buckets=[1, 2, 4, 8])
    TI.create_predictor(off).run([feed])
    assert stat_get("STAT_autotune_trials") == t1
    assert os.path.isdir(tmp_path / "cache" / "policy")
