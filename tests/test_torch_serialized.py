"""The port's serving artifact, its C ABI and the program cache against the
JAX package's, on the CPU.

One inference bundle of ``chip_smoke.build_bert_encoder`` (2 layers, H 64,
one head of 64 so that attention is the flash op, S 16), saved by the JAX
package's ``io.save_inference_model``, is exported by both packages'
Predictors, statically (batch 4, smaller batches padded up) and with a
dynamic batch (padded up the ladder), and each artifact's
``SerializedPredictor`` is held against the other package's (fp32, rtol
and atol 1e-5). The JAX package cannot export the encoder with a dynamic
batch (its layer_norm lowering takes the leading size as a constant), so
its dynamic artifact is of the JAX serving tests' MLP bundle, which both
packages export and serve. The port's artifact is served by a subprocess
that cannot import ``paddle_tpu_torch``, ``paddle_tpu`` or ``jax``, and by
the C client (``capi.py``), bitwise against the port's
``SerializedPredictor`` (bf16 as raw words). A warm Predictor in a fresh process hits the program
cache, runs neither the pass pipeline nor an export, and matches the cold
one bitwise; damaged entries heal; the executor writes nothing.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import inference as JI

import paddle_tpu_torch as tpt
from paddle_tpu_torch import capi
from paddle_tpu_torch import inference as TI
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.core import program_cache
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import layer_norm as tln
from paddle_tpu_torch.kernels import serving_ops, traced
from paddle_tpu_torch.monitor import reset_all, stat_get

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

F32 = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(layers_n=2, H=64, heads=1, FF=128, vocab=100, max_pos=32,
             types=2, S=16)
FEEDS = list(chip_smoke.INFER_FEEDS)
STATIC_B = 4


def _feed(b, seed=0):
    return chip_smoke.bert_encoder_feed(b, SMALL, seed=seed, lo=4)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    import jax.numpy as jnp
    d = str(tmp_path_factory.mktemp("bundle"))
    main, _, out = chip_smoke.build_bert_encoder(jpt, **SMALL)
    scope = jpt.Scope()
    for k, v in chip_smoke.bert_encoder_state(main).items():
        scope.set(k, jnp.asarray(v))
    jpt.io.save_inference_model(d, FEEDS, [out], jpt.Executor(),
                                main_program=main, scope=scope)
    return d


def _port_predictor(d, bf16=False, cache=None, quant=None):
    cfg = TI.Config(d)
    cfg.disable_gpu()
    if bf16:
        cfg.enable_bf16()
    if quant:
        cfg.enable_quant(quant)
    if cache is not None:
        cfg.enable_program_cache(cache)
    return TI.create_predictor(cfg)


_SERVE_FRAMEWORK_FREE = textwrap.dedent("""
    import importlib.util, sys
    for name in ("paddle_tpu_torch", "paddle_tpu", "jax"):
        sys.modules[name] = None  # any import of them raises
    art, feeds, out = sys.argv[1:4]
    spec = importlib.util.spec_from_file_location(
        "serving_core", art + "/serving_core.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    import numpy as np
    core = mod.SerializedCore(art)
    with np.load(feeds) as f:
        got = core.run([f["f%d" % i] for i in range(len(f.files))])
    np.save(out, got[0])
    assert not [m for m in sys.modules if sys.modules[m] is not None and
                m.split(".")[0] in ("paddle_tpu", "paddle_tpu_torch", "jax")]
    print("launches", core.launches)
""")


_BLOCK_FRAMEWORK = textwrap.dedent("""
    import sys
    for name in ("paddle_tpu_torch", "paddle_tpu", "jax"):
        sys.modules[name] = None  # any import of them raises
""")


_WARM_PROCESS = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import paddle_tpu_torch.core.passes as passes
    from paddle_tpu_torch import inference as TI
    from paddle_tpu_torch.monitor import stat_get
    bundle, cache, feeds, out = sys.argv[1:5]
    def refuse(*a, **k):
        raise AssertionError("a warm start ran the pipeline or an export")
    passes.apply_pass = TI.apply_pass = refuse
    torch.export.export = refuse
    cfg = TI.Config(bundle)
    cfg.disable_gpu()
    cfg.enable_program_cache(cache)
    p = TI.create_predictor(cfg)
    assert p.cache_hit and p.program is None
    assert stat_get("STAT_program_cache_trace_hit") == 1
    with np.load(feeds) as f:
        got = p.run([f["f%d" % i] for i in range(len(f.files))])
    np.save(out, got[0])
""")


def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PADDLE_TPU_SHAPE_BUCKETS")}
    env.update(PADDLE_TPU_SERVING_DEVICE="cpu", **extra)
    return env


def _mlp_bundle(d):
    """The JAX serving tests' bundle: x [6] -> fc 16 relu -> fc 3."""
    main, startup = jpt.Program(), jpt.Program()
    with jpt.program_guard(main, startup):
        x = jpt.layers.data("x", [6])
        y = jpt.layers.fc(jpt.layers.fc(x, 16, act="relu"), 3)
    exe = jpt.Executor()
    exe.run(startup)
    jpt.io.save_inference_model(d, ["x"], [y], exe, main_program=main)
    return d


@pytest.fixture(scope="module")
def artifacts(bundle, tmp_path_factory):
    """Artifact dirs by (package, kind): the encoder static (both) and
    dynamic and bf16 (the port), the MLP dynamic (both); the encoder's
    program cache, made by a cold Predictor; and the three processes
    that serve them out of this one (the framework-free loader, the C
    client, a warm Predictor), started here so that they run beside the
    in-process tests."""
    root = tmp_path_factory.mktemp("artifacts")
    mlp = _mlp_bundle(str(root / "mlp"))
    out = {"bundle": bundle, "root": root}
    for pkg, pred, mpred in (
            ("jax", JI.create_predictor(JI.Config(bundle)),
             JI.create_predictor(JI.Config(mlp))),
            ("port", _port_predictor(bundle), _port_predictor(mlp))):
        pred.export_serialized(str(root / f"{pkg}_static"), _feed(STATIC_B))
        mpred.export_serialized(str(root / f"{pkg}_mlp"),
                                [np.zeros((2, 6), np.float32)],
                                dynamic_batch=True)
        out[pkg, "static"] = str(root / f"{pkg}_static")
        out[pkg, "mlp"] = str(root / f"{pkg}_mlp")
    out["mlp_bundle"] = mlp
    # the encoder with a dynamic batch, written from a cold Predictor of
    # the program cache (the warm process below reads that cache)
    cold = _port_predictor(bundle, cache=str(root / "cache"))
    out["cold"] = cold
    out["port", "dynamic"] = str(root / "port_dynamic")
    cold.export_serialized(out["port", "dynamic"], _feed(STATIC_B),
                           dynamic_batch=True)
    out["port", "bf16"] = str(root / "port_bf16")
    _port_predictor(bundle, bf16=True).export_serialized(
        out["port", "bf16"], _feed(STATIC_B))
    feed = _feed(3, seed=7)
    np.savez(root / "feeds.npz", **{f"f{i}": v for i, v in enumerate(feed)})
    out["feed"] = feed
    procs = {}
    block = root / "block"
    block.mkdir()
    (block / "sitecustomize.py").write_text(_BLOCK_FRAMEWORK)
    (root / "serve.py").write_text(_SERVE_FRAMEWORK_FREE)
    procs["free"] = subprocess.Popen(
        [sys.executable, str(root / "serve.py"), out["port", "dynamic"],
         str(root / "feeds.npz"), str(root / "free.npy")], cwd=root,
        env=_clean_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    if capi.shared_libpython():
        ind, outd = root / "c_in", root / "c_out"
        ind.mkdir()
        outd.mkdir()
        for i, v in enumerate(feed):
            capi.write_tensor(str(ind / f"in{i}.bin"), v)
        procs["c"] = subprocess.Popen(
            [str(capi.client()), out["port", "bf16"], "--raw", str(ind),
             str(outd)], cwd=root, env=_clean_env(PYTHONPATH=str(block)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        out["c_out"] = outd
    (root / "warm.py").write_text(_WARM_PROCESS)
    procs["warm"] = subprocess.Popen(
        [sys.executable, str(root / "warm.py"), bundle, str(root / "cache"),
         str(root / "feeds.npz"), str(root / "warm.npy")], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    out["procs"] = procs
    yield out
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def _finished(proc):
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, (stdout[-2000:], stderr[-3000:])
    return stdout


def _mlp_feed(b, seed=0):
    return [np.random.default_rng(seed).standard_normal(
        (b, 6)).astype(np.float32)]


@pytest.mark.parametrize("kind", ["static", "dynamic"])
def test_export_parity_with_jax(artifacts, kind, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SHAPE_BUCKETS", "1,2,4,8")
    key = "static" if kind == "static" else "mlp"
    jsp = JI.SerializedPredictor(artifacts["jax", key])
    tsp = TI.SerializedPredictor(artifacts["port", key], device="cpu")
    assert tsp.get_input_names() == jsp.get_input_names()
    sizes = (1, 3, 4) if kind == "static" else (1, 3, 5)
    make = _feed if kind == "static" else _mlp_feed
    for b in sizes:
        feed = make(b, seed=b)
        want, = jsp.run(feed)
        got, = tsp.run(feed)
        assert got.shape == np.asarray(want).shape and got.shape[0] == b
        np.testing.assert_allclose(got, np.asarray(want), **F32)
    # 1 and 3 rows pad up to the static batch 4; 3 and 5 up the ladder
    assert tsp.core.stats["padded_calls"] == 2
    assert tsp.core.stats["pad_rows"] == (3 + 1 if kind == "static"
                                          else 1 + 3)
    if kind == "static":
        with pytest.raises(ValueError, match="exceeds the artifact"):
            tsp.run(_feed(STATIC_B + 1))
    else:  # the port's encoder with a dynamic batch, against its Predictor
        dsp = TI.SerializedPredictor(artifacts["port", "dynamic"],
                                     device="cpu")
        pred = _port_predictor(artifacts["bundle"])
        for b in (1, 3, 6):
            feed = _feed(b, seed=30 + b)
            np.testing.assert_allclose(dsp.run(feed)[0], pred.run(feed)[0],
                                       **F32)
        assert dsp.core.stats["pad_rows"] == 1 + 2


def test_the_artifact_holds_the_kernel_ops_and_its_loader(artifacts):
    d = artifacts["port", "dynamic"]
    sig = json.loads(Path(d, "signature.json").read_text())
    n = SMALL["layers_n"]
    assert sig["kernel_ops"] == {"layer_norm_fwd": 2 * n + 1,
                                 "flash_attention_fwd": n}
    assert sig["batch"] == "dyn" and sig["device"] == "cpu"
    assert sig["kernel_libraries"] == ["flash_attention", "layer_norm"]
    pkg = Path(tpt.__file__).parent
    assert Path(d, "serving_ops.py").read_bytes() == \
        (pkg / "kernels" / "serving_ops.py").read_bytes()
    assert Path(d, "serving_core.py").read_bytes() == \
        (pkg / "serving_core.py").read_bytes()
    shipped = sorted(os.listdir(Path(d, "kernels")))
    assert "layer_norm.cu" in shipped and "flash_attention.cu" in shipped
    # exported on the CPU: no library, built from the sources on a card
    assert not [f for f in shipped if f.endswith(".so")]
    # the files written into an artifact import neither package nor jax
    import ast
    for f in ("serving_ops.py", "serving_core.py"):
        tree = ast.parse(Path(d, f).read_text())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names} | {n.module or "" for n in ast.walk(tree)
                                     if isinstance(n, ast.ImportFrom)}
        assert not [m for m in mods if m.split(".")[0] in
                    ("jax", "paddle_tpu", "paddle_tpu_torch")], mods


def _declarations(path):
    """A C header's text without its comments."""
    text = re.sub(r"/\*.*?\*/", "", Path(path).read_text(), flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def test_the_c_header_is_the_jax_packages():
    """The one thing served across the packages is the C ABI: a client
    built on either header links against either library (the .pt2 and the
    StableHLO artifacts are each their own package's). The declarations
    are the JAX package's character for character; only the comments may
    differ."""
    port = _declarations(ROOT / "paddle_tpu_torch" / "csrc" / "pt_c_api.h")
    assert "PT_NewPredictor" in port and "PT_BFLOAT16" in port
    assert port == _declarations(ROOT / "csrc" / "pt_c_api.h")


def test_ops_run_plain_on_the_cpu_and_register_once(tmp_path):
    mod = traced.register()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 5, 64), np.float32))
    g, b = torch.ones(64), torch.zeros(64)
    y, mean, rstd = torch.ops.paddle_tpu.layer_norm_fwd(x, g, b, 1e-5)
    want = tln.layer_norm_reference(x, g, b, 1e-5)
    for got, ref in zip((y, mean, rstd), want):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 1, 16, 64),
                                                    np.float32))
               for _ in range(3))
    bias = torch.zeros(2, 1, 1, 16)
    o, lse = torch.ops.paddle_tpu.flash_attention_fwd(q, k, v, bias, False,
                                                      0.125)
    ro, rlse = tfa.attention_reference(q, k, v, bias, False, 0.125)
    torch.testing.assert_close(o, ro, **F32)
    torch.testing.assert_close(lse, rlse, **F32)
    # o is laid out [B, S, H, D] as the CUDA wrapper lays it out
    assert o.stride() == torch.empty(2, 16, 1, 64).transpose(1, 2).stride()
    # a second copy of the file, loaded by path, finds the owner
    copy = tmp_path / "serving_ops.py"
    shutil.copy(serving_ops.__file__, copy)
    import importlib.util
    spec = importlib.util.spec_from_file_location("ops_copy", copy)
    other = importlib.util.module_from_spec(spec)
    sys.modules["ops_copy"] = other
    spec.loader.exec_module(other)
    assert other.register(libraries={"x": "y"}) is mod
    assert mod.libraries["x"] == "y"
    del mod.libraries["x"]
    # the CUDA kernel of an op is the launcher, never the plain version;
    # a launcher counts its own launches (the package's wrappers, in theirs)
    calls = []
    mod.launchers["layer_norm_fwd"] = lambda *a: calls.append(a) or a[:3]
    try:
        n0 = dict(mod.launches)
        mod._ln_cuda(x, g, b, 1e-5)
        assert len(calls) == 1 and mod.launches == n0
    finally:
        traced.register()


@pytest.mark.parametrize("rc", [0, 2])
def test_an_artifacts_own_launch_counts_only_a_launch_made(monkeypatch, rc):
    """Without the package's launchers (an artifact's process) an op
    launches through the file's own C interface, which the package's
    wrappers share; ``launches[op]`` moves right after the C call, never
    for an input with no rows, and a failed launch raises."""
    mod = traced.register()
    seen = []

    def function(library, symbol, argtypes):
        def call(*args):
            if symbol == "pt_flash_attention_fwd":
                args += (tuple((ctypes.c_longlong * 20).from_address(
                    args[13])),)
            seen.append((symbol, args))
            return rc
        return call
    monkeypatch.setattr(mod, "_function", function)
    monkeypatch.setattr(mod, "_stream", lambda device: 0)
    monkeypatch.setattr(mod, "launchers", {})
    n0 = dict(mod.launches)
    x = torch.zeros(0, 64)
    mod._ln_cuda(x, torch.ones(64), torch.zeros(64), 1e-5)
    assert seen == [] and mod.launches == n0
    x = torch.zeros(3, 5, 64)
    q = k = v = torch.zeros(2, 4, 16, 64).transpose(1, 2)  # [2, 16, 4, 64]
    bias = torch.zeros(2, 1, 1, 4)
    for name, call in (
            ("layer_norm_fwd",
             lambda: mod._ln_cuda(x, torch.ones(64), torch.zeros(64), 1e-5)),
            ("flash_attention_fwd",
             lambda: mod._fa_cuda(q, k, v, bias, False, 0.125))):
        before = mod.launches[name]
        if rc:
            with pytest.raises(RuntimeError, match=f"cudaError {rc}"):
                call()
        else:
            call()
        assert mod.launches[name] == before + 1
    (ln, ln_args), (fa, fa_args) = seen
    assert ln == "pt_layer_norm_fwd" and ln_args[6:10] == (15, 64, 1e-5, 0)
    assert fa == "pt_flash_attention_fwd" and fa_args[8:13] == \
        (2, 16, 4, 4, 64)
    # q's strides, then the bias broadcast to [B, H, Sq, Sk] with stride 0
    assert fa_args[-1][:3] == q.stride()[:3]
    assert fa_args[-1][12:16] == (4, 0, 0, 1)


def test_symbolic_batch_in_the_fake_kernels():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv
    traced.register()
    with FakeTensorMode(shape_env=ShapeEnv()) as mode:
        q = mode.from_tensor(torch.empty(8, 2, 16, 64))
        o, lse = torch.ops.paddle_tpu.flash_attention_fwd(q, q, q, None,
                                                          True, 0.125)
        assert o.shape == (8, 2, 16, 64) and lse.shape == (8, 2, 16)
        assert o.stride() == (2048, 64, 128, 1)
        y, mean, rstd = torch.ops.paddle_tpu.layer_norm_fwd(
            q, torch.ones(64), torch.zeros(64), 1e-5)
        assert y.shape == q.shape and mean.shape == (8, 2, 16) and \
            rstd.dtype == torch.float32


@pytest.mark.skipif(not capi.shared_libpython(),
                    reason="this Python has no shared libpython to embed")
def test_c_client_reports_a_bad_artifact(tmp_path):
    proc = subprocess.run([str(capi.client()), str(tmp_path / "nope"), "4"],
                          capture_output=True, text=True, timeout=120,
                          env=_clean_env())
    assert proc.returncode == 1
    assert "serving_core.py" in proc.stderr


def test_what_cannot_be_exported_raises(tmp_path, monkeypatch):
    main, _, outs = chip_smoke.cf_cond(tpt)
    d = str(tmp_path / "cond")
    tpt.save_inference_model(d, ["x", "flag"], outs, tpt.Executor("cpu"),
                             main_program=main, scope=tpt.Scope())
    p = _port_predictor(d)
    with pytest.raises(ValueError, match="'conditional_block'|'cond"):
        p.export_serialized(str(tmp_path / "art"),
                            [np.ones((2, 2), np.float32),
                             np.array([[True], [True]])])
    monkeypatch.setenv("PADDLE_TPU_MESH", "dp2")
    with pytest.raises(NotImplementedError, match="A6"):
        TI.SerializedPredictor(str(tmp_path / "art"), device="cpu")


def test_the_pool_serves_a_serialized_predictor(artifacts):
    sp = TI.SerializedPredictor(artifacts["port", "dynamic"], device="cpu")
    with tserving.PredictorPool(sp, max_batch=8, bucketing=True) as pool:
        pool.warmup(_feed(1))
        reqs = [_feed(b, seed=20 + b) for b in (1, 2, 3)]
        futs = [pool.submit(r) for r in reqs]
        for f, r in zip(futs, reqs):
            np.testing.assert_allclose(f.result(timeout=60)[0],
                                       sp.run(r)[0], **F32)


# ---------------------------------------------------------------------------
# the program cache
# ---------------------------------------------------------------------------

def _damage(path, how):
    blob = Path(path).read_bytes()
    if how == "truncated":
        Path(path).write_bytes(blob[:len(blob) // 2])
    elif how == "corrupt":
        Path(path).write_bytes(blob[:200] + bytes(4096) + blob[4296:])
    else:  # a header from another torch
        nl = blob.index(b"\n", len(program_cache.MAGIC))
        hdr = json.loads(blob[len(program_cache.MAGIC):nl])
        hdr["torch"] = "0.0.0"
        Path(path).write_bytes(program_cache.MAGIC + json.dumps(hdr).encode()
                               + blob[nl:])


@pytest.mark.parametrize("how", ["truncated", "corrupt", "skewed"])
def test_damaged_entries_self_heal(artifacts, tmp_path_factory, how):
    bundle = artifacts["mlp_bundle"]
    cache = str(tmp_path_factory.getbasetemp() / "heal_cache")
    if not os.path.isdir(cache):
        _port_predictor(bundle, cache=cache)
    entry, = [str(p) for p in Path(cache, "trace").glob("*.pt2")]
    good = Path(entry).read_bytes()
    _damage(entry, how)
    reset_all()
    p = _port_predictor(bundle, cache=cache)
    assert stat_get("STAT_program_cache_corrupt") == 1
    assert not p.cache_hit and p._module is not None
    # rebuilt in place; a third predictor hits it
    assert len(Path(entry).read_bytes()) == len(good)
    again = _port_predictor(bundle, cache=cache)
    assert again.cache_hit
    feed = _mlp_feed(2, seed=3)
    assert p.run(feed)[0].tobytes() == again.run(feed)[0].tobytes()


@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_a_warm_start_binds_the_bundles_parameters_as_the_cold_one(
        artifacts, tmp_path, form):
    """The entry holds no weights: a warm Predictor reads the bundle's
    parameters and makes the bf16 cast or the int8 weights and scales as
    the cold one's pipeline made them, bitwise."""
    kw = {"bf16": True} if form == "bf16" else {"quant": "int8"}
    cache = str(tmp_path / "cache")
    cold = _port_predictor(artifacts["mlp_bundle"], cache=cache, **kw)
    # the entry is the graph alone: no weights, no example inputs
    ep, _ = program_cache.load_program(cache, cold.fingerprint)
    assert not ep.state_dict and ep.example_inputs is None
    reset_all()
    warm = _port_predictor(artifacts["mlp_bundle"], cache=cache, **kw)
    assert warm.cache_hit and warm.program is None
    assert stat_get("STAT_program_cache_trace_hit") == 1
    assert sorted(warm._params) == sorted(cold._params)
    for n, t in cold._params.items():
        assert warm._params[n].dtype == t.dtype
        assert torch.equal(warm._params[n], t), n
    if form == "int8":
        assert any(t.dtype == torch.int8 for t in warm._params.values())
    feed = _mlp_feed(3, seed=5)
    assert warm.run(feed)[0].tobytes() == cold.run(feed)[0].tobytes()


def test_the_executor_with_a_cache_dir_runs_the_same_and_writes_nothing(
        tmp_path):
    main, startup, outs = chip_smoke.cf_cond(tpt)
    feed = {"x": np.array([[1.0, 3.0]], np.float32),
            "flag": np.array([True])}
    got = tpt.Executor("cpu", program_cache_dir=str(tmp_path / "c")).run(
        main, feed=feed, fetch_list=outs, scope=tpt.Scope())
    want = tpt.Executor("cpu").run(main, feed=feed, fetch_list=outs,
                                   scope=tpt.Scope())
    assert got[0].tobytes() == want[0].tobytes()
    assert not os.path.exists(tmp_path / "c")


def test_warmup_goes_through_the_ladder_report(artifacts, tmp_path):
    cfg = TI.Config(artifacts["mlp_bundle"])
    cfg.disable_gpu()
    cfg.switch_shape_bucketing(True, buckets=[1, 2, 4])
    cfg.enable_program_cache(str(tmp_path / "cache"))
    reset_all()
    report = TI.create_predictor(cfg).warmup_buckets(_mlp_feed(1))
    assert list(report) == [4, 2, 1]
    assert all(r["disk_warm"] is False and r["graph"] is False and
               "error" not in r for r in report.values())
    assert stat_get("STAT_program_cache_warm") == 3
    warm = TI.create_predictor(cfg).warmup_buckets(_mlp_feed(1))
    assert all(r["disk_warm"] for r in warm.values())


# ---------------------------------------------------------------------------
# the processes started by the fixture (last, so that they ran meanwhile)
# ---------------------------------------------------------------------------

def test_a_warm_predictor_in_a_fresh_process(artifacts):
    """The cold Predictor wrote the cache and serves the module it read
    back; a fresh process hits the entry, runs no pass and no export, and
    matches it bitwise."""
    cold = artifacts["cold"]
    assert not cold.cache_hit and cold._module is not None
    want, = cold.run(artifacts["feed"])
    plain, = _port_predictor(artifacts["bundle"]).run(artifacts["feed"])
    np.testing.assert_allclose(want, plain, **F32)
    _finished(artifacts["procs"]["warm"])
    got = np.load(artifacts["root"] / "warm.npy")
    assert got.tobytes() == want.tobytes()


def test_an_artifact_serves_without_the_framework(artifacts):
    """A process in which paddle_tpu_torch, paddle_tpu and jax cannot be
    imported loads serving_core.py by path and serves the artifact
    bitwise as the port's SerializedPredictor does."""
    out = _finished(artifacts["procs"]["free"])
    want, = TI.SerializedPredictor(artifacts["port", "dynamic"],
                                   device="cpu").run(artifacts["feed"])
    got = np.load(artifacts["root"] / "free.npy")
    assert got.tobytes() == want.tobytes()
    # its launches through the ops (the CPU kernels count none)
    assert "launches" in out


@pytest.mark.skipif(not capi.shared_libpython(),
                    reason="this Python has no shared libpython to embed")
def test_c_client_is_bitwise_the_serialized_predictor(artifacts):
    """The C client, its embedded interpreter barred from the framework
    too, serves the bf16 artifact: its raw bf16 words equal the core's."""
    stdout = _finished(artifacts["procs"]["c"])
    assert "outputs=1" in stdout
    outd = artifacts["c_out"]
    got = [capi.read_tensor(str(outd / f)) for f in sorted(os.listdir(outd))]
    sp = TI.SerializedPredictor(artifacts["port", "bf16"], device="cpu")
    want = sp.core.run(artifacts["feed"])
    assert len(got) == len(want) == 1
    assert got[0].dtype == want[0].dtype == np.uint16
    assert got[0].shape == (3, SMALL["S"], SMALL["H"])
    assert got[0].tobytes() == want[0].tobytes()
    # the facade widens the words to float32, exactly
    wide, = sp.run(artifacts["feed"])
    assert wide.dtype == np.float32 and np.array_equal(
        wide.view(np.uint32) >> 16, got[0].astype(np.uint32))
