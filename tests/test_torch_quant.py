"""The port's weight quantization against the JAX package's, on the CPU.

``quant``'s functions on the same numpy arrays in both packages (int8
payloads, scales and the int32 accumulator of ``qmatmul`` bitwise equal;
fp8 payloads bitwise), the npz artifacts and the convert CLI across the
packages, the decoder's fp32 seams as bitwise no-ops, int8 logits within
the JAX package's budget, the engine with int8 and fp8 weights against the
JAX engine (greedy streams and stats), and the Predictor's
``enable_quant`` against the JAX Predictor's.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jpt
import paddle_tpu.generation as J
from paddle_tpu import inference as JI
from paddle_tpu import quant as JQ
from paddle_tpu.core.registry import REGISTRY as JREG
from paddle_tpu.monitor import gauge_get as jgauge
from paddle_tpu.monitor import stat_get as jstat

import paddle_tpu_torch.generation as T
from paddle_tpu_torch import inference as TI
from paddle_tpu_torch import quant as TQ
from paddle_tpu_torch.core.registry import REGISTRY as TREG
from paddle_tpu_torch.core.registry import LowerCtx
from paddle_tpu_torch.jit import load_reference_params
from paddle_tpu_torch.monitor import gauge_get as tgauge
from paddle_tpu_torch.monitor import stat_get as tstat

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)

CFG_KW = dict(vocab_size=128, hidden=64, layers=2, heads=4, max_seq_len=64)
JCFG, TCFG = J.DecoderConfig(**CFG_KW), T.DecoderConfig(**CFG_KW)
GEO = dict(num_blocks=18, block_size=4, decode_width=3, prefill_chunk=4)
ROOMY = dict(GEO, num_blocks=64)
MAX_STEPS = 400
# tests/test_quantized_serving.py's budgets: decoder logits against fp32,
# and a Predictor's output against fp32
MAX_ABS_BUDGET, MSE_BUDGET = 0.25, 5e-3
PRED_MAX_ABS, PRED_MSE = 0.1, 1e-3
# the port against the JAX package: the same int8 codes and scales, fp32
# arithmetic in other orders (the decoder's and the encoder's F32 rule)
F32 = dict(atol=1e-5, rtol=1e-4)
STATS = ("STAT_generation_tokens", "STAT_generation_prefills",
         "STAT_generation_prefix_hits", "STAT_generation_prefix_cow_copies",
         "STAT_generation_evictions", "STAT_generation_kv_quant_blocks",
         "STAT_generation_spec_proposed", "STAT_generation_spec_accepted")


@pytest.fixture(scope="module")
def params():
    return T.init_params(TCFG, seed=0)


@pytest.fixture(scope="module")
def jq(params):
    return {m: JQ.quantize_decoder_params(params, m) for m in ("int8", "fp8")}


def _np(v):
    """Payload bits as numpy: fp8 as its bytes."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.float8_e4m3fn:
            return v.view(torch.uint8).numpy()
        return v.numpy()
    a = np.asarray(v)
    return a.view(np.uint8) if a.dtype.kind == "V" or \
        str(a.dtype).startswith("float8") else a


def _same_checkpoint(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)


# --------------------------------------------------------------------------
# the scale contract and the quantized math
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode,axis", [("int8", 1), ("int8", 0),
                                       ("fp8", 1), ("fp8", 0)])
def test_quantize_array_equals_the_reference(mode, axis):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    w[:, 3] = 0.0
    w[5] = 0.0
    q, s = TQ.quantize_array(w, axis, mode)
    jq_, js = JQ.quantize_array(w, axis, mode)
    np.testing.assert_array_equal(_np(q), _np(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(TQ.channel_absmax(w, axis),
                                  JQ.channel_absmax(w, axis))
    back = TQ.dequantize_array(q, s, axis).numpy()
    np.testing.assert_array_equal(back, np.asarray(
        JQ.dequantize_array(jq_, js, axis)))
    dead = back[:, 3] if axis == 1 else back[5]
    assert np.all(dead == 0.0)


def test_qmatmul_accumulator_and_output_equal_the_reference():
    """The activations quantize to the same codes and the int32 product is
    exact on both sides; the rescale follows the JAX order, so the outputs
    agree bit for bit."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    x[1, 2] = 0.0                       # a zero row keeps scale 1
    w = rng.normal(size=(64, 40)).astype(np.float32)
    q, s = TQ.quantize_array(w, 1, "int8")
    jq_, js = JQ.quantize_array(w, 1, "int8")
    got = TQ.qmatmul(torch.from_numpy(x), q, s).numpy()
    want = np.asarray(JQ.qmatmul(jnp.asarray(x), jq_, js))
    np.testing.assert_array_equal(got, want)
    xq = np.clip(np.round(x / np.where(np.abs(x).max(-1, keepdims=True) > 0,
                                       np.abs(x).max(-1, keepdims=True)
                                       * np.float32(1 / 127), 1)), -127, 127)
    acc = TQ._int_matmul(torch.from_numpy(xq.reshape(-1, 64).astype(np.int8)),
                         q)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(
        acc.numpy(), xq.reshape(-1, 64).astype(np.int64) @
        np.asarray(q.numpy(), np.int64))


def test_fp32_seams_are_bitwise_noops(params):
    tp = load_reference_params(TCFG, params, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, TCFG.hidden)).astype(np.float32))
    assert torch.equal(TQ.matmul(tp, "l0_wqkv", x),
                       torch.matmul(x, tp["l0_wqkv"]))
    idx = torch.tensor([0, 5, 2])
    assert torch.equal(TQ.embed(tp, "tok_emb", idx), tp["tok_emb"][idx])


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_decoder_params_equals_the_reference(params, jq, mode):
    got = TQ.quantize_decoder_params(params, mode)
    _same_checkpoint(got, jq[mode])
    assert TQ.is_quantized(got) and not TQ.is_quantized(params)
    assert TQ.weight_bytes_saved(got) == JQ.weight_bytes_saved(jq[mode]) > 0
    assert TQ.quantize_decoder_params(got, mode) == got      # idempotent
    assert TQ.quantize_decoder_params(params, "off") == dict(params)


def test_qat_adapters_equal_the_reference_and_invert(params, jq):
    q = TQ.quantize_decoder_params(params, "int8")
    slim = TQ.to_qat(q)
    _same_checkpoint(slim, JQ.to_qat(jq["int8"]))
    _same_checkpoint(TQ.from_qat(slim), q)
    jslim = {k: np.asarray(v) for k, v in JQ.to_qat(jq["int8"]).items()}
    _same_checkpoint(TQ.from_qat(jslim), JQ.from_qat(jslim))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_and_load_quantized_across_the_packages(tmp_path, params, jq,
                                                     writer):
    path = str(tmp_path / "q.npz")
    q = TQ.quantize_decoder_params(params, "int8")
    if writer == "port":
        TQ.save_quantized(path, q, "int8")
    else:
        JQ.save_quantized(path, jq["int8"], "int8")
    for load in (TQ.load_quantized, JQ.load_quantized):
        back, mode = load(path)
        assert mode == "int8"
        _same_checkpoint(back, q)


def test_fp8_artifact_keeps_its_bits(tmp_path, params):
    path = str(tmp_path / "f8.npz")
    q = TQ.quantize_decoder_params(params, "fp8")
    TQ.save_quantized(path, q, "fp8")
    back, mode = TQ.load_quantized(path)
    assert mode == "fp8" and back["l0_w1"].dtype == torch.float8_e4m3fn
    _same_checkpoint(back, q)
    # the layout numpy gives the JAX package's fp8 arrays
    assert np.load(path)["l0_w1"].dtype.str == "|V1"


@pytest.mark.parametrize("cli", ["port", "jax"])
def test_convert_cli_demo_loads_in_either_package(tmp_path, cli):
    from paddle_tpu.quant.convert import main as jmain
    from paddle_tpu_torch.quant.convert import main as tmain
    out = str(tmp_path / "demo.npz")
    assert (tmain if cli == "port" else jmain)(
        ["--demo", "--out", out, "--mode", "int8"]) == 0
    tback, tmode = TQ.load_quantized(out)
    jback, jmode = JQ.load_quantized(out)
    assert tmode == jmode == "int8" and TQ.is_quantized(tback)
    _same_checkpoint(tback, jback)
    assert TQ.weight_bytes_saved(tback) == JQ.weight_bytes_saved(jback) > 0
    # the demo decoder loads as a checkpoint of DecoderConfig()
    tp = load_reference_params(T.DecoderConfig(), tback, "cpu")
    assert tp["l0_wqkv"].dtype == torch.int8


def test_convert_cli_in_and_from_qat(tmp_path, params):
    from paddle_tpu_torch.quant.convert import main
    src = str(tmp_path / "ckpt.npz")
    np.savez(src, **params)
    out = str(tmp_path / "q.npz")
    assert main(["--in", src, "--out", out]) == 0
    _same_checkpoint(TQ.load_quantized(out)[0],
                     TQ.quantize_decoder_params(params, "int8"))
    slim = str(tmp_path / "slim.npz")
    np.savez(slim, **{k: _np(v) for k, v in TQ.to_qat(
        TQ.quantize_decoder_params(params, "int8")).items()})
    out2 = str(tmp_path / "q2.npz")
    assert main(["--in", slim, "--out", out2, "--from-qat"]) == 0
    _same_checkpoint(TQ.load_quantized(out2)[0], TQ.load_quantized(out)[0])
    with pytest.raises(SystemExit):
        main(["--out", out])


# --------------------------------------------------------------------------
# the decoder with quantized weights
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fault", ["no scale", "scale shape", "extra scale",
                                   "fp32 with scale"])
def test_load_reference_params_checks_a_quantized_checkpoint(params, fault):
    q = dict(TQ.quantize_decoder_params(params, "int8"))
    if fault == "no scale":
        del q["l0_w1::scale"]
    elif fault == "scale shape":
        q["tok_emb::scale"] = q["tok_emb::scale"][:3]
    elif fault == "extra scale":
        q["l9_w1::scale"] = q["l0_w1::scale"]
    else:
        q["l0_b1::scale"] = torch.ones(1)
    with pytest.raises((KeyError, ValueError), match="load_reference_params"):
        load_reference_params(TCFG, q, "cpu")


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_logits_equal_the_reference_and_stay_in_budget(params, jq,
                                                                 mode):
    rng = np.random.default_rng(2)
    toks = rng.integers(0, TCFG.vocab_size, size=(4, 24)).astype(np.int32)
    lens = np.asarray([24, 13, 6, 1], np.int32)
    tq = load_reference_params(TCFG, TQ.quantize_decoder_params(params, mode),
                               "cpu")
    assert tq["l0_w1"].dtype == TQ.storage_dtype(mode)
    lq = T.forward_full(TCFG, tq, torch.from_numpy(toks),
                        torch.from_numpy(lens))[0].numpy()
    lf = T.forward_full(TCFG, load_reference_params(TCFG, params, "cpu"),
                        torch.from_numpy(toks),
                        torch.from_numpy(lens))[0].numpy()
    want = np.asarray(J.forward_full(
        JCFG, {k: jnp.asarray(v) for k, v in jq[mode].items()},
        jnp.asarray(toks), jnp.asarray(lens))[0])
    np.testing.assert_allclose(lq, want, **F32)
    d = lf - lq
    assert np.abs(d).max() < MAX_ABS_BUDGET and (d ** 2).mean() < MSE_BUDGET
    assert np.array_equal(lf.argmax(-1), lq.argmax(-1))


def _requests(pkg):
    """tests/test_torch_generation.py's prompts: in GEO's pool they share
    prefixes (hits, copy-on-write) and run the pool dry (preemption)."""
    rng = np.random.default_rng(1)

    def draw(n):
        return [int(x) for x in rng.integers(0, 128, n)]
    shared = draw(10)
    prompts = [shared + draw(3), shared + draw(9), [1, 2, 3, 4, 5],
               shared + draw(1), shared + draw(6), draw(30), draw(21),
               draw(14), draw(1)]
    return [pkg.GenerationRequest(prompt=p, max_new_tokens=12 + i % 7,
                                  request_id=i)
            for i, p in enumerate(prompts)]


def _run(pkg, cfg, params, **kw):
    stat = jstat if pkg is J else tstat
    before = {n: stat(n) for n in STATS}
    if pkg is T:
        kw["device"] = "cpu"
    eng = pkg.GenerationEngine(cfg, params, **kw)
    res = eng.generate(_requests(pkg), max_steps=MAX_STEPS)
    return ({r.request_id: r.tokens for r in res},
            {n: stat(n) - before[n] for n in STATS}, eng)


@pytest.mark.parametrize("mode,spec", [("int8", 0), ("int8", 2), ("fp8", 0)])
def test_quantized_engine_equals_the_jax_engine(params, mode, spec):
    """int8 or fp8 weights (KV auto -> int8) with the prefix cache,
    copy-on-write and preemption (and speculation): greedy streams and
    stats equal the JAX engine's, and the gauge is the checkpoint's
    saving."""
    kw = dict(GEO, quant_mode=mode, spec_tokens=spec)
    jstreams, jstats, jeng = _run(J, JCFG, params, **kw)
    streams, stats, eng = _run(T, TCFG, params, **kw)
    assert streams == jstreams and stats == jstats
    assert eng.kv_dtype == jeng.kv_dtype == "int8"
    assert eng.k_pools.dtype == torch.int8 and TQ.is_quantized(eng.params)
    assert tgauge("GAUGE_quant_weight_bytes_saved") == \
        TQ.weight_bytes_saved(TQ.quantize_decoder_params(params, mode)) == \
        jgauge("GAUGE_quant_weight_bytes_saved") > 0
    assert stats["STAT_generation_prefix_cow_copies"] > 0
    assert stats["STAT_generation_evictions"] > 0
    assert stats["STAT_generation_kv_quant_blocks"] > 0
    if spec:
        assert stats["STAT_generation_spec_proposed"] > 0


def test_quantized_spec_over_the_prefix_cache_matches_fp32(params):
    """tests/test_quantized_serving.py's composition test on the port, its
    requests and engine as there: greedy streams over an int8 pool with
    the prefix cache, copy-on-write and speculation equal the fp32
    engine's on these short contexts, and the JAX engine's int8 ones."""
    geo = dict(num_blocks=48, block_size=4, decode_width=2, prefill_chunk=4,
               prefix_cache=True, spec_tokens=2)

    def run(pkg, cfg, **kw):
        stat = jstat if pkg is J else tstat
        h0 = stat("STAT_generation_prefix_hits")
        if pkg is T:
            kw["device"] = "cpu"
        eng = pkg.GenerationEngine(cfg, params, **geo, **kw)
        reqs = [pkg.GenerationRequest(
            request_id=i, prompt=[3] * 8 + [i + 1] * 2, max_new_tokens=8,
            sampling=pkg.SamplingParams(seed=i)) for i in range(3)]
        out = eng.generate(reqs, max_steps=MAX_STEPS)
        assert stat("STAT_generation_prefix_hits") > h0
        return {r.request_id: r.tokens for r in out}, eng
    fp32, _ = run(T, TCFG)
    q, eng = run(T, TCFG, quant_mode="int8")
    assert q == fp32 and eng.k_scales is not None
    assert q == run(J, JCFG, quant_mode="int8")[0]


def test_a_preconverted_checkpoint_passes_through(tmp_path, params):
    path = str(tmp_path / "q.npz")
    TQ.save_quantized(path, TQ.quantize_decoder_params(params, "int8"),
                      "int8")
    ckpt, mode = TQ.load_quantized(path)
    a, _, ea = _run(T, TCFG, ckpt, quant_mode=mode, **ROOMY)
    b, _, eb = _run(T, TCFG, params, quant_mode="int8", **ROOMY)
    assert a == b and ea.kv_dtype == "int8"
    # quant off with fp32 weights: fp32 state and no saving
    _, _, e32 = _run(T, TCFG, params, **ROOMY)
    assert e32.quant_mode == "off" and e32.kv_dtype == "fp32"
    assert e32.k_scales is None and not TQ.is_quantized(e32.params)
    assert tgauge("GAUGE_quant_weight_bytes_saved") == 0


def test_the_pool_restart_republishes_the_quant_gauges(params, monkeypatch):
    from paddle_tpu_torch.serving import PoolRestarted
    eng = T.GenerationEngine(TCFG, params, device="cpu", quant_mode="int8",
                             **ROOMY)
    saved = tgauge("GAUGE_quant_weight_bytes_saved")
    assert saved > 0
    real = eng._run_mixed
    calls = []

    def flaky(*a):
        calls.append(1)
        if len(calls) == 1:
            T.GenerationEngine(TCFG, params, device="cpu", **ROOMY)
            raise RuntimeError("injected step fault")
        return real(*a)
    monkeypatch.setattr(eng, "_run_mixed", flaky)
    with T.GenerationPool(eng) as pool:
        doomed = pool.submit(T.GenerationRequest(prompt=[1, 2],
                                                 max_new_tokens=3))
        with pytest.raises(PoolRestarted):
            doomed.result(timeout=60)
        assert tgauge("GAUGE_quant_weight_bytes_saved") == saved
        ok = pool.submit(T.GenerationRequest(prompt=[1, 2],
                                             max_new_tokens=3))
        assert len(ok.result(timeout=60).tokens) == 3


def test_the_quant_flags_set_the_engine(params):
    from paddle_tpu_torch import flags
    keys = ("FLAGS_quant_mode", "FLAGS_generation_spec_tokens",
            "FLAGS_generation_draft", "FLAGS_generation_prefill_buckets")
    before = {k: flags.get_flag(k) for k in keys}
    assert before == {"FLAGS_quant_mode": "off",
                      "FLAGS_generation_spec_tokens": 0,
                      "FLAGS_generation_draft": "ngram",
                      "FLAGS_generation_prefill_buckets": "pow2:512"}
    try:
        flags.set_flags({"quant_mode": "int8", "generation_spec_tokens": 2})
        eng = T.GenerationEngine(TCFG, params, device="cpu", **ROOMY)
        assert (eng.quant_mode, eng.kv_dtype, eng.spec_tokens) == \
            ("int8", "int8", 2)
    finally:
        flags.set_flags(before)


# --------------------------------------------------------------------------
# the dequantize ops and the Predictor
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,ins,attrs", [
    ("fake_dequantize_max_abs", ("X", "Scale"), {"max_range": 127.0}),
    ("fake_channel_wise_dequantize_max_abs", ("X", "Scales"),
     {"quant_bits": [8], "quant_axis": 1}),
    ("fake_channel_wise_dequantize_max_abs", ("X", "Scales", "Scales"),
     {"quant_bits": [8, 8], "quant_axis": 0})])
def test_dequantize_ops_equal_the_reference(name, ins, attrs):
    rng = np.random.default_rng(4)
    x = rng.integers(-127, 128, (6, 5)).astype(np.float32)
    axis = attrs.get("quant_axis", 0)
    vals = {"X": [x], "Scale": [np.asarray([2.5], np.float32)],
            "Scales": [rng.random(x.shape[axis]).astype(np.float32) + 0.5,
                       np.asarray([3.0], np.float32)]}
    jins = {"X": [jnp.asarray(x)]}
    tins = {"X": [torch.from_numpy(x)]}
    if "Scale" in ins:
        jins["Scale"] = [jnp.asarray(vals["Scale"][0])]
        tins["Scale"] = [torch.from_numpy(vals["Scale"][0])]
    else:
        n = ins.count("Scales")
        jins["Scales"] = [jnp.asarray(v) for v in vals["Scales"][:n]]
        tins["Scales"] = [torch.from_numpy(v) for v in vals["Scales"][:n]]
    want = JREG.get(name).lower(None, jins, attrs)["Out"][0]
    got = TREG.get(name).lower(LowerCtx("cpu"), tins, attrs)["Out"][0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


SMALL = dict(layers_n=2, H=64, heads=4, FF=128, vocab=100, max_pos=32,
             types=2, S=16)
FEEDS = list(chip_smoke.INFER_FEEDS)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """chip_smoke's BERT encoder at SMALL, saved by the JAX package."""
    d = str(tmp_path_factory.mktemp("bundle"))
    main, _, out = chip_smoke.build_bert_encoder(jpt, **SMALL)
    scope = jpt.Scope()
    for k, v in chip_smoke.bert_encoder_state(main).items():
        scope.set(k, jnp.asarray(v))
    jpt.io.save_inference_model(d, FEEDS, [out], jpt.Executor(),
                                main_program=main, scope=scope)
    return d


def _predictors(d, quant=True, buckets=None):
    jc, tc = JI.Config(d), TI.Config(d)
    tc.disable_gpu()
    for c in (jc, tc):
        if quant:
            c.enable_quant("int8")
        if buckets:
            c.switch_shape_bucketing(True, buckets=buckets)
    return JI.create_predictor(jc), TI.create_predictor(tc)


def test_the_predictor_quantizes_as_the_jax_predictor(bundle):
    jp, tp = _predictors(bundle)
    _, tf = _predictors(bundle, quant=False)
    assert [op.type for op in tp.program.global_block.ops] == \
        [op.type for op in jp.program.global_block.ops]
    assert "fake_channel_wise_dequantize_max_abs" in \
        [op.type for op in tp.program.global_block.ops]
    int8 = [n for b in tp.program.blocks for n, v in b.vars.items()
            if v.dtype == "int8"]
    assert int8
    for n in int8:
        w = tp.scope.find_var(n)
        s = tp.scope.find_var(n + ".quant_scale")
        assert w.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(w.numpy(),
                                      np.asarray(jp.scope.find_var(n)))
        np.testing.assert_array_equal(s.numpy(), np.asarray(
            jp.scope.find_var(n + ".quant_scale")))
    assert tgauge("GAUGE_quant_weight_bytes_saved") == \
        jgauge("GAUGE_quant_weight_bytes_saved") > 0
    for b in (1, 3):
        feed = chip_smoke.bert_encoder_feed(b, SMALL, seed=b, lo=4)
        got, = tp.run(feed)
        want, = jp.run(feed)
        ref, = tf.run(feed)
        np.testing.assert_allclose(got, np.asarray(want), **F32)
        d = got - ref
        assert np.abs(d).max() < PRED_MAX_ABS and (d ** 2).mean() < PRED_MSE


def test_the_predictor_quantizes_the_jax_tests_fc_model(tmp_path):
    """tests/test_quantized_serving.py's model: two fc layers, initialised
    by the JAX package's startup program as there."""
    main, startup = jpt.Program(), jpt.Program()
    with jpt.program_guard(main, startup):
        x = jpt.layers.data("x", [6])
        h = jpt.layers.fc(x, 16, act="relu")
        y = jpt.layers.fc(h, 3, name="out")
    exe = jpt.Executor()
    exe.run(startup)
    d = str(tmp_path / "fc")
    jpt.io.save_inference_model(d, ["x"], [y], exe, main_program=main)
    xb = np.random.default_rng(4).normal(size=(5, 6)).astype(np.float32)
    jp, tp = _predictors(d)
    _, tf = _predictors(d, quant=False)
    got, want, ref = tp.run([xb])[0], jp.run([xb])[0], tf.run([xb])[0]
    np.testing.assert_allclose(got, np.asarray(want), **F32)
    dlt = got - ref
    assert np.abs(dlt).max() < PRED_MAX_ABS and (dlt ** 2).mean() < PRED_MSE


def test_the_predictor_refuses_bf16_and_fp8(bundle):
    cfg = TI.Config(bundle)
    cfg.disable_gpu()
    with pytest.raises(ValueError, match="fp8"):
        cfg.enable_quant("fp8")
    cfg.enable_quant("int8")
    cfg.enable_bf16()
    with pytest.raises(ValueError, match="bf16"):
        TI.create_predictor(cfg)
    cfg = TI.Config(bundle)
    cfg.disable_gpu()
    cfg.enable_quant()
    cfg.disable_quant()
    p = TI.create_predictor(cfg)
    assert p.quant_mode == "off"
    assert "fake_channel_wise_dequantize_max_abs" not in \
        [op.type for op in p.program.global_block.ops]


def test_the_quantized_predictor_on_buckets(bundle):
    """Bucketed runs (the CUDA-graph path on the card, eager here) give the
    unbucketed answer."""
    _, tp = _predictors(bundle, buckets="1,2,4")
    _, plain = _predictors(bundle)
    feed = chip_smoke.bert_encoder_feed(3, SMALL, seed=9, lo=4)
    np.testing.assert_allclose(tp.run(feed)[0], plain.run(feed)[0], **F32)
