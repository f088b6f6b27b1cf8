"""The port's Paddle Inference path against the JAX package's, on the CPU.

Each new op (lookup_table, dropout, scale, clip, cast, the reduce_*
family, fused_embedding_eltwise_layernorm) runs through both executors on
the same numpy inputs, and its gradients through ``minimize``; each pass
of the inference pipeline rewrites both packages' programs to the same
ops and outputs and keeps the JAX pass guards; an inference bundle of the
BERT encoder of ``chip_smoke.build_bert_encoder`` (2 layers, H 64, 4
heads, vocab 100, S 16) saved by either package is served by the other's
``Predictor``, with the pass pipeline on and off, on a bucket ladder and
in bf16; and the io functions round-trip state across the packages.
Tolerances: fp32 atol 1e-5, rtol 1e-4 (the JAX tests' rule); bf16 within
2^-6 of the largest value.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jpt
from paddle_tpu import inference as JI
from paddle_tpu.core.passes import apply_pass as japply
from paddle_tpu.monitor import stat_get as jstat

import paddle_tpu_torch as tpt
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import inference as TI
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import passes as tpasses
from paddle_tpu_torch.core.scope import load_reference_scope
from paddle_tpu_torch.monitor import reset_all, stat_get
from paddle_tpu_torch.nn.functional import (layer_norm_paths_taken,
                                            reset_layer_norm_path_log)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)

F32 = dict(atol=1e-5, rtol=1e-4)
SMALL = dict(layers_n=2, H=64, heads=4, FF=128, vocab=100, max_pos=32,
             types=2, S=16)
FEEDS = list(chip_smoke.INFER_FEEDS)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ids(shape, hi, seed=0):
    return np.random.default_rng(seed).integers(0, hi, shape).astype(
        np.int64)


def _exe(pt):
    return pt.Executor("cpu") if pt is tpt else pt.Executor()


def _put(pt, scope, name, value):
    if pt is tpt:
        load_reference_scope(scope, {name: value}, "cpu")
    else:
        scope.set(name, jnp.asarray(value))


def _feed_of(cfg, b, lo=4, seed=chip_smoke.INFER_SEED + 1):
    return chip_smoke.bert_encoder_feed(b, cfg, seed=seed, lo=lo)


# ---------------------------------------------------------------------------
# each new op through both executors
# ---------------------------------------------------------------------------

def _run_op(pt, op, ins, attrs, outs=("Out",)):
    """One op in a program of its own, every input fed, through package
    ``pt``'s executor: its outputs as float arrays."""
    main = pt.Program()
    blk = main.global_block
    feed, inputs = {}, {}
    for slot, vals in ins.items():
        inputs[slot] = []
        for i, v in enumerate(vals):
            name = "%s_%d" % (slot.lower(), i)
            blk.create_var(name, shape=list(v.shape), dtype=str(v.dtype))
            feed[name] = v
            inputs[slot].append(name)
    for s in outs:
        blk.create_var("out_" + s)
    blk.append_op(op, inputs, {s: ["out_" + s] for s in outs}, attrs)
    got = _exe(pt).run(main, feed=feed, fetch_list=["out_" + s for s in outs],
                       scope=pt.Scope())
    return [np.asarray(g) for g in got]


_X = _rand((2, 3, 4))
_XZ = np.where(_rand((2, 3, 4), 1) > 0.3, _X, 0.0).astype(np.float32)
OP_CASES = {
    "lookup_table": ("lookup_table", {"W": [_rand((10, 4))],
                                      "Ids": [_ids((2, 3, 1), 10)]}, {}),
    "lookup_table_padding_idx": (
        "lookup_table", {"W": [_rand((10, 4))],
                         "Ids": [np.array([[[2], [5]], [[2], [0]]])]},
        {"padding_idx": 2}),
    "lookup_table_negative_padding_idx": (
        "lookup_table", {"W": [_rand((10, 4))],
                         "Ids": [np.array([[[8], [5]], [[2], [8]]])]},
        {"padding_idx": -2}),
    "lookup_table_v2": ("lookup_table_v2", {"W": [_rand((10, 4))],
                                            "Ids": [_ids((2, 3), 10)]}, {}),
    "lookup_table_v2_padding_idx": (
        "lookup_table_v2", {"W": [_rand((10, 4))],
                            "Ids": [np.array([[1, 4], [1, 1]])]},
        {"padding_idx": 1}),
    "dropout_test_upscale": ("dropout", {"X": [_X]},
                             {"dropout_prob": 0.3, "is_test": True,
                              "dropout_implementation": "upscale_in_train"}),
    "dropout_test_downgrade": ("dropout", {"X": [_X]},
                               {"dropout_prob": 0.3, "is_test": True}),
    "dropout_p0_train": ("dropout", {"X": [_X]}, {"dropout_prob": 0.0}),
    "scale_bias_after": ("scale", {"X": [_X]},
                         {"scale": 2.5, "bias": -0.5}),
    "scale_bias_before": ("scale", {"X": [_X]},
                          {"scale": 10000.0, "bias": -1.0,
                           "bias_after_scale": False}),
    "clip": ("clip", {"X": [_X]}, {"min": -0.5, "max": 0.7}),
    "clip_int": ("clip", {"X": [_ids((3, 4), 20).astype(np.int32)]},
                 {"min": 3.0, "max": 11.0}),
    "cast_int32": ("cast", {"X": [_X * 5]}, {"out_dtype": "int32"}),
    "cast_float16": ("cast", {"X": [_X]}, {"out_dtype": "float16"}),
    "cast_to_float": ("cast", {"X": [_ids((3, 4), 9)]},
                      {"out_dtype": "float32"}),
    "reduce_sum_dim1_keep": ("reduce_sum", {"X": [_X]},
                             {"dim": [1], "keep_dim": True}),
    "reduce_sum_all": ("reduce_sum", {"X": [_X]}, {"reduce_all": True}),
    "reduce_sum_default_dim": ("reduce_sum", {"X": [_X]}, {}),
    "reduce_mean_int_dim": ("reduce_mean", {"X": [_X]}, {"dim": -1}),
    "reduce_mean_empty_dim": ("reduce_mean", {"X": [_X]}, {"dim": []}),
    "reduce_max_neg": ("reduce_max", {"X": [_X]}, {"dim": [-1]}),
    "reduce_min_two": ("reduce_min", {"X": [_X]}, {"dim": [0, 2]}),
    "reduce_prod": ("reduce_prod", {"X": [_X]}, {"dim": [1, 2],
                                                 "keep_dim": True}),
    "reduce_any": ("reduce_any", {"X": [_XZ]}, {"dim": [2]}),
    "reduce_all": ("reduce_all", {"X": [_XZ]}, {"dim": [1]}),
    "max": ("max", {"X": [_X]}, {}),
    "min": ("min", {"X": [_X]}, {}),
    "fused_embedding_eltwise_layernorm": (
        "fused_embedding_eltwise_layernorm",
        {"Ids": [_ids((2, 5, 1), 10), _ids((2, 5, 1), 6, 1)],
         "Embs": [_rand((10, 8)), _rand((6, 8), 1)],
         "Scale": [1.0 + 0.1 * _rand((8,), 2)], "Bias": [_rand((8,), 3)]},
        {"epsilon": 1e-5}),
}
OP_OUTS = {"dropout": ("Out", "Mask")}


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_through_both_executors(name):
    op, ins, attrs = OP_CASES[name]
    outs = OP_OUTS.get(op, ("Out",))
    want = _run_op(jpt, op, ins, attrs, outs)
    got = _run_op(tpt, op, ins, attrs, outs)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        # the JAX package runs 64-bit types off (int64 -> int32) and
        # returns bool reductions as bool
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), **F32)


def _dropout_run(impl, storage, x, p):
    from paddle_tpu_torch.flags import set_flags
    main = tpt.Program()
    main.random_seed = 11
    blk = main.global_block
    blk.create_var("x", shape=list(x.shape))
    for n in ("out", "mask"):
        blk.create_var(n)
    blk.append_op("dropout", {"X": ["x"]}, {"Out": ["out"], "Mask": ["mask"]},
                  {"dropout_prob": p, "dropout_implementation": impl})
    set_flags({"FLAGS_dropout_storage": storage})
    try:
        return tpt.Executor("cpu").run(main, feed={"x": x},
                                       fetch_list=["out", "mask"],
                                       scope=tpt.Scope())
    finally:
        set_flags({"FLAGS_dropout_storage": "xla"})


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
@pytest.mark.parametrize("storage", ["xla", "u8", "seed"])
def test_dropout_training_out_mask_and_rate(impl, storage):
    """Out == X Mask / (1 - p) (upscale) or X Mask (downgrade), the Mask
    0/1, the drop rate within 3 sigma of p, and under every
    FLAGS_dropout_storage value the Out and Mask of "xla" from one seed."""
    p = 0.25
    x = _rand((64, 128), 4) + 3.0
    out, mask = _dropout_run(impl, storage, x, p)
    assert set(np.unique(mask)) == {0.0, 1.0}
    want = x * mask / (1 - p) if impl == "upscale_in_train" else x * mask
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=0)
    rate = 1.0 - mask.mean()
    assert abs(rate - p) < 3 * np.sqrt(p * (1 - p) / mask.size)
    ref_out, ref_mask = _dropout_run(impl, "xla", x, p)
    np.testing.assert_array_equal(mask, ref_mask)
    np.testing.assert_array_equal(out, ref_out)


def _grad_program(pt, reduce_op, padding_idx):
    """ids -> embedding (padding_idx) and x -> fc, each through scale,
    clip and ``reduce_op`` into one scalar loss; SGD(0.1)."""
    layers = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = layers.data("x", [6])
        ids = layers.data("ids", [5, 1], dtype="int64")
        e = layers.embedding(ids, size=[10, 6], padding_idx=padding_idx,
                             param_attr=pt.ParamAttr(name="emb"))
        h = layers.fc(x, 6, param_attr=pt.ParamAttr(name="fc_w"),
                      bias_attr=False)
        parts = []
        for v in (h, e):
            v = layers.clip(layers.scale(v, 1.5, 0.1, bias_after_scale=False),
                            -0.9, 0.8)
            parts.append(getattr(layers, reduce_op)(v, dim=-1))
        loss = layers.reduce_mean(layers.elementwise_add(
            layers.reduce_sum(parts[0]), layers.reduce_sum(parts[1])))
        pt.optimizer.SGD(0.1).minimize(loss, startup_program=startup,
                                       program=main)
    return main, startup, loss


@pytest.mark.parametrize("padding_idx", [None, 3])
@pytest.mark.parametrize("reduce_op", ["reduce_sum", "reduce_mean",
                                       "reduce_max", "reduce_min",
                                       "reduce_prod"])
def test_gradients_through_minimize(reduce_op, padding_idx):
    """The loss, W@GRAD of the table and the fc and both after one SGD
    step, from one carried state."""
    rng = np.random.default_rng(5)
    state = {"emb": rng.standard_normal((10, 6)).astype(np.float32),
             "fc_w": rng.standard_normal((6, 6)).astype(np.float32) * 0.5}
    feed = {"x": rng.standard_normal((4, 6)).astype(np.float32),
            "ids": np.array([[[3], [1], [3], [7], [0]]] * 4)}
    res = []
    for pt in (jpt, tpt):
        main, startup, loss = _grad_program(pt, reduce_op, padding_idx)
        scope = pt.Scope()
        _exe(pt).run(startup, scope=scope)
        for k, v in state.items():
            _put(pt, scope, k, v)
        vals = _exe(pt).run(main, feed=feed,
                            fetch_list=[loss, "emb@GRAD", "fc_w@GRAD"],
                            scope=scope)
        after = [np.asarray(scope.find_var(n) if pt is jpt else
                            scope.find_var(n).numpy()) for n in state]
        res.append([np.asarray(v) for v in vals] + after)
    for g, w in zip(res[1], res[0]):
        np.testing.assert_allclose(g, w, **F32)
    if padding_idx is not None:
        assert not res[1][1][padding_idx].any()


# ---------------------------------------------------------------------------
# the layer builders and the passes, in both packages
# ---------------------------------------------------------------------------

def _builders(pt):
    layers = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        ids = layers.data("ids", [5, 1], dtype="int64")
        x = layers.data("x", [3, 4])
        e = layers.embedding(ids, [12, 4], padding_idx=0)
        y = layers.dropout(layers.scale(x, 2.0, 1.0), 0.2)
        y = layers.clip(layers.cast(y, "float32"), -1.0, 1.0)
        for fn in ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
                   "reduce_prod", "reduce_any", "reduce_all"):
            getattr(layers, fn)(y, dim=1, keep_dim=True)
            getattr(layers, fn)(e)
    return main, startup


def test_port_layers_build_the_jax_program():
    jm, js = _builders(jpt)
    tm, ts = _builders(tpt)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()


def _encoder(pt, cfg=SMALL, train=False):
    main, startup, out = chip_smoke.build_bert_encoder(pt, **cfg)
    if train:
        with pt.program_guard(main, startup):
            loss = pt.layers.mean(out)
            pt.optimizer.SGD(0.1).minimize(loss, startup_program=startup,
                                           program=main)
    return main, startup, out


def test_the_encoder_builds_the_same_program_in_both_packages():
    jm, js, jout = _encoder(jpt)
    tm, ts, tout = _encoder(tpt)
    assert tm.to_dict() == jm.to_dict() and ts.to_dict() == js.to_dict()
    assert tout.shape == (-1, SMALL["S"], SMALL["H"])
    types = [op.type for op in tm.global_block.ops]
    assert types.count("lookup_table") == 3
    assert types.count("dropout") == 1 + 2 * SMALL["layers_n"]
    assert types.count("layer_norm") == 1 + 2 * SMALL["layers_n"]


PIPELINE = TI.GpuPassStrategy().passes()


def _passed(pt, apply, names, train=False):
    main, _, out = _encoder(pt, train=train)
    # eval-mode dropout unless test_prune sets it
    prog = main.clone(for_test=not train)
    for n in names:
        prog = apply(prog, n, protected={out.name})
    return prog, out.name


PASS_CASES = {"test_prune": ["test_prune"],
              "drop_dropout_eval": ["test_prune", "drop_dropout_eval"],
              "embedding_eltwise_layernorm_fuse":
                  ["embedding_eltwise_layernorm_fuse"],
              "multihead_matmul_fuse": ["multihead_matmul_fuse"],
              "fuse_elewise_add_act": ["fuse_elewise_add_act"],
              "pipeline": ["test_prune"] + PIPELINE}


@pytest.mark.parametrize("name", sorted(PASS_CASES))
def test_pass_rewrites_both_packages_alike(name):
    """The op types after the pass (the whole JSON but for the packed
    attention vars' stop_gradient, ROADMAP.md C2), then the outputs of
    the rewritten programs from one carried state."""
    train = name in ("test_prune", "drop_dropout_eval", "pipeline")
    jp, out = _passed(jpt, japply, PASS_CASES[name], train)
    tp, _ = _passed(tpt, tpasses.apply_pass, PASS_CASES[name], train)
    jd, td = jp.to_dict(), tp.to_dict()
    assert [o["type"] for o in td["blocks"][0]["ops"]] == \
        [o["type"] for o in jd["blocks"][0]["ops"]]
    assert td["blocks"][0]["ops"] == jd["blocks"][0]["ops"]
    jv = {v["name"]: v for v in jd["blocks"][0]["vars"]}
    tv = {v["name"]: v for v in td["blocks"][0]["vars"]}
    assert sorted(n for n in jv if jv[n] != tv[n]) == sorted(
        n for n in jv if n.startswith("mha_fuse_") and "_xs_" not in n)
    types = [o["type"] for o in td["blocks"][0]["ops"]]
    if name == "pipeline":
        assert "dropout" not in types and "lookup_table" not in types
        assert types.count("multihead_matmul") == SMALL["layers_n"]
        assert types.count("fused_embedding_eltwise_layernorm") == 1
    if name == "test_prune":
        assert "backward" not in types and "sgd" not in types
    state = chip_smoke.bert_encoder_state(jp)
    feed = dict(zip(FEEDS, _feed_of(SMALL, 2)))
    res = []
    for pt, prog in ((jpt, jp), (tpt, tp)):
        scope = pt.Scope()
        for k, v in state.items():
            _put(pt, scope, k, v)
        res.append(np.asarray(_exe(pt).run(prog, feed=feed,
                                           fetch_list=[out],
                                           scope=scope)[0]))
    np.testing.assert_allclose(res[1], res[0], **F32)


def _guard_programs(pt):
    """The JAX guard tests' programs (tests/test_io_inference.py:361-418)
    and two more: a begin_norm_axis=1 norm and a fetched embedding sum.
    {name: (program, pass, protected)}."""
    layers = pt.layers
    out = {}

    def emb_sum(padding_idx=None, axis=2, tap=False, mean_tap=False):
        main = pt.Program()
        with pt.program_guard(main, pt.Program()):
            a = layers.data("a", [4, 1], dtype="int64")
            b = layers.data("b", [4, 1], dtype="int64")
            s = layers.elementwise_add(
                layers.embedding(a, size=[10, 8], padding_idx=padding_idx),
                layers.embedding(b, size=[10, 8]))
            layers.layer_norm(s, begin_norm_axis=axis)
        ln = next(op for op in main.global_block.ops
                  if op.type == "layer_norm")
        protected = set()
        if tap:
            protected.add(s.name)
        if mean_tap:
            protected.add(ln.output("Mean")[0])
        return main, "embedding_eltwise_layernorm_fuse", protected

    out["fuses"] = emb_sum()
    out["padding_idx"] = emb_sum(padding_idx=0)
    out["norm_axis_1"] = emb_sum(axis=1)
    out["fetched_sum"] = emb_sum(tap=True)
    out["consumed_mean"] = emb_sum(mean_tap=True)
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        layers.multi_head_attention(layers.data("x", [4, 8]), 2)
    probs = next(op.output("Out")[0] for op in main.global_block.ops
                 if op.type == "softmax")
    out["mha_fuses"] = (main, "multihead_matmul_fuse", set())
    out["mha_probs_tap"] = (main.clone(), "multihead_matmul_fuse", {probs})
    return out


@pytest.mark.parametrize("name", ["fuses", "padding_idx", "norm_axis_1",
                                  "fetched_sum", "consumed_mean",
                                  "mha_fuses", "mha_probs_tap"])
def test_fuse_pass_guards(name):
    got = {}
    for pt, apply in ((jpt, japply), (tpt, tpasses.apply_pass)):
        prog, pas, protected = _guard_programs(pt)[name]
        got[pt.__name__] = [op.type for op in apply(
            prog.clone(), pas, protected=protected).global_block.ops]
    assert got["paddle_tpu_torch"] == got["paddle_tpu"]
    fused = {"fused_embedding_eltwise_layernorm",
             "multihead_matmul"} & set(got["paddle_tpu"])
    assert bool(fused) == (name in ("fuses", "mha_fuses"))


def test_amp_rewrite_still_raises_naming_a2b():
    """The amp_rewrite pass, ported now, rewrites the encoder program as the
    JAX pass does: the same ops (its casts, each just before its consumer)
    and the same vars and dtypes, for bf16 and fp16."""
    for dtype in ("bfloat16", "float16"):
        want = japply(_encoder(jpt)[0], "amp_rewrite", dtype=dtype)
        got = tpasses.apply_pass(_encoder(tpt)[0], "amp_rewrite",
                                 dtype=dtype)
        assert got.to_dict() == want.to_dict()
        assert [op.type for op in got.global_block.ops].count("cast") > 0


# ---------------------------------------------------------------------------
# inference bundles across the packages
# ---------------------------------------------------------------------------

def _save_bundle(pt, d, cfg=SMALL):
    main, _, out = chip_smoke.build_bert_encoder(pt, **cfg)
    state = chip_smoke.bert_encoder_state(main)
    scope = pt.Scope()
    for k, v in state.items():
        _put(pt, scope, k, v)
    pt.io.save_inference_model(str(d), FEEDS, [out], _exe(pt),
                               main_program=main, scope=scope)
    return str(d)


@pytest.fixture(scope="module")
def jax_bundle(tmp_path_factory):
    return _save_bundle(jpt, tmp_path_factory.mktemp("jax_bundle"))


@pytest.fixture(scope="module")
def port_bundle(tmp_path_factory):
    return _save_bundle(tpt, tmp_path_factory.mktemp("port_bundle"))


def _configs(d, ir_optim=True, bf16=False, buckets=None):
    jc, tc = JI.Config(d), TI.Config(d)
    tc.disable_gpu()
    for c in (jc, tc):
        c.switch_ir_optim(ir_optim)
        if bf16:
            c.enable_bf16()
        if buckets is not None:
            c.switch_shape_bucketing(True, buckets=buckets)
    return jc, tc


@pytest.mark.parametrize("ir_optim", [True, False])
def test_port_serves_a_jax_bundle(jax_bundle, ir_optim):
    jc, tc = _configs(jax_bundle, ir_optim)
    jp, tp = JI.create_predictor(jc), TI.create_predictor(tc)
    assert tp.get_input_names() == FEEDS == jp.get_input_names()
    assert [op.type for op in tp.program.global_block.ops] == \
        [op.type for op in jp.program.global_block.ops]
    for b in (1, 3):
        feed = _feed_of(SMALL, b, seed=b)
        want, = jp.run(feed)
        got, = tp.run(feed)
        assert got.shape == (b, SMALL["S"], SMALL["H"]) and \
            got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(want), **F32)


def test_fused_path_logs_the_plain_layer_norm_on_the_cpu(jax_bundle):
    _, tc = _configs(jax_bundle)
    reset_layer_norm_path_log()
    TI.create_predictor(tc).run(_feed_of(SMALL, 2))
    assert layer_norm_paths_taken() == \
        ["reference"] + ["composed"] * (2 * SMALL["layers_n"])


def test_bucketed_runs_match_jax_and_count(jax_bundle):
    """A ladder [1, 2, 4, 8] at batches 3, 5 and 3 again: rows equal the
    JAX bucketed Predictor's, and the port's counters (cold, hit, padded
    rows) are the JAX package's; on the CPU no graph is captured."""
    jc, tc = _configs(jax_bundle, buckets=[1, 2, 4, 8])
    jp, tp = JI.create_predictor(jc), TI.create_predictor(tc)
    reset_all()
    names = ("bucket_cold", "bucket_hit", "pad_rows", "bucket_overflow")
    j0 = {n: jstat("STAT_predictor_" + n) for n in names}
    for b in (3, 5, 3, 9):
        feed = _feed_of(SMALL, b, seed=10 + b)
        want, = jp.run(feed)
        got, = tp.run(feed)
        assert got.shape[0] == b
        np.testing.assert_allclose(got, np.asarray(want), **F32)
    for n in names:
        assert stat_get("STAT_predictor_" + n) == \
            jstat("STAT_predictor_" + n) - j0[n], n
    assert stat_get("STAT_predictor_bucket_cold") == 3
    assert stat_get("STAT_predictor_pad_rows") == 1 + 3 + 1
    assert stat_get("STAT_predictor_graph_capture") == 0


@pytest.mark.parametrize("ir_optim", [True, False])
def test_bf16_against_the_jax_bf16_predictor(jax_bundle, ir_optim):
    """Off the pipeline the attention's bf16 scores meet the fp32 key
    bias and promote, as jnp promotes them, through the matmuls."""
    jc, tc = _configs(jax_bundle, ir_optim, bf16=True)
    feed = _feed_of(SMALL, 3)
    want = np.asarray(JI.create_predictor(jc).run(feed)[0]).astype(
        np.float32)
    tp = TI.create_predictor(tc)
    got, = tp.run(feed)
    # a bf16 fetch comes back widened to float32
    assert got.dtype == np.float32
    assert tp.scope.find_var("word_embedding").dtype == torch.bfloat16
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 2.0 ** -6 * scale


def test_jax_serves_a_port_bundle(port_bundle, jax_bundle):
    """The port's bundle loads in the JAX package (the same JSON and npz
    names) and gives the port's answers, which are the JAX bundle's."""
    jc, tc = _configs(port_bundle)
    feed = _feed_of(SMALL, 2)
    want, = JI.create_predictor(jc).run(feed)
    got, = TI.create_predictor(tc).run(feed)
    np.testing.assert_allclose(got, np.asarray(want), **F32)
    jdir = Path(jax_bundle)
    pdir = Path(port_bundle)
    import json
    assert json.loads((pdir / "__model__").read_text()) == \
        json.loads((jdir / "__model__").read_text())
    with np.load(pdir / "__params__.npz") as p, \
            np.load(jdir / "__params__.npz") as j:
        assert sorted(p.files) == sorted(j.files)
        for k in p.files:
            np.testing.assert_array_equal(p[k], j[k])


def test_handles_and_warmup_on_the_cpu(port_bundle):
    _, tc = _configs(port_bundle, buckets="pow2:4")
    tp = TI.create_predictor(tc)
    feed = _feed_of(SMALL, 3)
    report = tp.warmup_buckets([f[:1] for f in feed])
    assert sorted(report) == [1, 2, 4]
    assert not any(r["graph"] for r in report.values())
    reset_all()
    for n, v in zip(FEEDS, feed):
        tp.get_input_handle(n).copy_from_cpu(v)
    tp.run()
    got = tp.get_output_handle(tp.get_output_names()[0]).copy_to_cpu()
    assert stat_get("STAT_predictor_bucket_hit") == 1
    _, plain = _configs(port_bundle)
    want, = TI.create_predictor(plain).run(feed)
    np.testing.assert_allclose(got, want, **F32)
    with pytest.raises(KeyError):
        tp.get_input_handle("nope")


def test_bucket_helpers_match_jax():
    for spec in ("pow2:32", "1,3,2,8", [4, 1, 4], "", None, "pow2:1"):
        assert TI.parse_bucket_ladder(spec) == JI.parse_bucket_ladder(spec)
    ladder = [1, 2, 4, 8]
    for n in (1, 3, 8, 9):
        assert TI.bucket_for(n, ladder) == JI.bucket_for(n, ladder)
        assert TI.bucket_or_exact(n, ladder) == JI.bucket_or_exact(n, ladder)
    assert TI.TpuPassStrategy is TI.GpuPassStrategy
    assert TI.GpuPassStrategy().passes() == JI.TpuPassStrategy().passes()


def test_config_device_rule(port_bundle, monkeypatch):
    """Config() means the card: without CUDA the Predictor raises unless
    the config asks for the CPU; enable_use_gpu(device_id) names
    cuda:<id>."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TI.create_predictor(TI.Config(port_bundle))
    cfg = TI.Config(port_bundle)
    cfg.enable_use_gpu(100, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cfg.device()
    cfg.disable_gpu()
    assert TI.create_predictor(cfg).device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg.enable_use_gpu(device_id=1)
    assert cfg.device() == torch.device("cuda", 1)


@pytest.mark.parametrize("call,queue", [
    (lambda c: c.enable_spmd("dp4"), "A6"),
    (lambda c: c.enable_program_cache(), "A5"),
    (lambda c: c.switch_autotune(True), "A5"),
    (lambda c: TI.SerializedPredictor("x"), "A5")])
def test_what_stays_unported_raises_naming_its_queue(call, queue):
    cfg = TI.Config("x")
    with pytest.raises(NotImplementedError, match=queue):
        call(cfg)
    cfg.switch_autotune(False)
    cfg.disable_quant()
    cfg.disable_spmd()
    cfg.disable_program_cache()


def test_export_serialized_raises_naming_a5(port_bundle):
    _, tc = _configs(port_bundle)
    with pytest.raises(NotImplementedError, match="A5"):
        TI.create_predictor(tc).export_serialized("x", [])


# ---------------------------------------------------------------------------
# io round trips
# ---------------------------------------------------------------------------

def _regression(pt):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [4])
        loss = pt.layers.mean(pt.layers.fc(x, 3))
        pt.optimizer.Adam(0.01).minimize(loss, startup_program=startup,
                                         program=main)
    return main, startup, loss


def _trained(pt, steps=2):
    main, startup, loss = _regression(pt)
    startup.random_seed = 3
    scope = pt.Scope()
    exe = _exe(pt)
    exe.run(startup, scope=scope)
    for _ in range(steps):
        exe.run(main, feed={"x": _rand((8, 4))}, fetch_list=[loss],
                scope=scope)
    return main, scope, exe


def _values(pt, scope, names):
    return {n: np.asarray(scope.find_var(n) if pt is jpt
                          else scope.find_var(n).numpy()) for n in names}


@pytest.mark.parametrize("writer,reader", [(tpt, tpt), (tpt, jpt),
                                           (jpt, tpt)])
@pytest.mark.parametrize("what", ["persistables", "params"])
def test_persistables_round_trip_across_packages(tmp_path, writer, reader,
                                                 what):
    main, scope, exe = _trained(writer)
    saved = getattr(writer.io, "save_" + what)(exe, str(tmp_path), main,
                                               scope=scope)
    kinds = {v.name: v for v in main.list_vars()}
    assert all(kinds[n].is_parameter for n in saved) == (what == "params")
    rmain = _regression(reader)[0]
    rscope = reader.Scope()
    getattr(reader.io, "load_" + what)(_exe(reader), str(tmp_path), rmain,
                                       scope=rscope)
    want = _values(writer, scope, saved)
    got = _values(reader, rscope, saved)
    for n in saved:
        np.testing.assert_array_equal(got[n], want[n])
    if reader is tpt:
        assert all(rscope.find_var(n).device.type == "cpu" for n in saved)


def test_load_vars_missing_name_raises(tmp_path):
    main, scope, exe = _trained(tpt)
    tio.save_vars(exe, str(tmp_path), vars=main.all_parameters()[:1],
                  scope=scope)
    with pytest.raises(RuntimeError, match="missing"):
        tio.load_persistables(exe, str(tmp_path), main, scope=tpt.Scope())


def test_save_load_program_state_across_packages(tmp_path, monkeypatch):
    """save(program, path) in the port: .pdparams, .pdopt and .pdmodel
    that the JAX package reads; load(program, path) and set_program_state
    put them back into the port's global scope."""
    main, scope, _ = _trained(tpt)
    with tpt.scope_guard(scope):
        tio.save(main, str(tmp_path / "m"))
    names = [v.name for v in main.persistable_vars()]
    want = _values(tpt, scope, names)
    params = jpt.io.load(str(tmp_path / "m.pdparams"))
    opt = jpt.io.load(str(tmp_path / "m.pdopt"))
    assert sorted(params) == sorted(v.name for v in main.all_parameters())
    for n, v in {**params, **opt}.items():
        np.testing.assert_array_equal(v, want[n])
    assert jpt.Program.from_json(
        (tmp_path / "m.pdmodel").read_text()).to_dict() == main.to_dict()
    fresh = tpt.Scope()
    # the global scope's functions load onto the default device
    monkeypatch.setattr(tdevice, "_DEVICE", "cpu")
    with tpt.scope_guard(fresh):
        tio.load(main, str(tmp_path / "m"))
        got = _values(tpt, fresh, names)
        tio.save_persistables(None, str(tmp_path / "p"), main)
        state = tio.load_program_state(str(tmp_path / "p"))
        assert tio.set_program_state(main, dict(state, extra=0)) == ["extra"]
    for n in names:
        np.testing.assert_array_equal(got[n], want[n])
        np.testing.assert_array_equal(state[n], want[n])


def test_dygraph_state_round_trip_across_packages(tmp_path):
    from paddle_tpu_torch.jit import state_of
    from paddle_tpu_torch.nn import Linear
    state = state_of(Linear(4, 3, device="cpu"))
    tio.save_dygraph(state, str(tmp_path / "lin"))
    params, opt = jpt.io.load_dygraph(str(tmp_path / "lin"))
    assert opt is None and sorted(params) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(params[k], v.detach().numpy())
    jpt.io.save_dygraph({k: v * 2 for k, v in params.items()},
                        str(tmp_path / "back.pdparams"))
    back, _ = tio.load_dygraph(str(tmp_path / "back"))
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], 2 * v.detach().numpy())


def test_bf16_fetch_widens_to_float32():
    main = tpt.Program()
    blk = main.global_block
    blk.create_var("x", shape=[2, 3])
    blk.create_var("y")
    blk.append_op("cast", {"X": ["x"]}, {"Out": ["y"]},
                  {"out_dtype": "bfloat16"})
    x = _rand((2, 3))
    y, = tpt.Executor("cpu").run(main, feed={"x": x}, fetch_list=["y"],
                                 scope=tpt.Scope())
    assert y.dtype == np.float32
    np.testing.assert_array_equal(
        y, torch.from_numpy(x).bfloat16().float().numpy())
