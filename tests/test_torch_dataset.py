"""The port's datasets and dataset loop against the JAX package, on the CPU.

The MultiSlot parsers (the native one, built from the port's copy of
``data_feed.cc``, and the plain Python one) against the JAX package's
``parse_multislot`` on the same bytes; ``DataFeedDesc``'s protobuf-text
round trip; ``InMemoryDataset`` and ``QueueDataset`` batches against the
JAX package's for the same files and shuffle seed; trainer sharding; and
``train_from_dataset``/``infer_from_dataset`` on a small Wide&Deep program
(vocab 200, 3 slots, dim 4, fc [8, 8]; ``chip_smoke.build_wd_program``)
against the JAX executor's own over the same files. Parsed values and
batches are compared exactly; the epoch at ``test_wide_deep_trains_as_jax``'s
tolerances (F32_TOL for each loss, PARAM_TOL for every parameter after),
since the two packages sum in other orders; the port's runs among
themselves bitwise.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.core.program import disable_static, enable_static
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.dataset import native as jnative
from paddle_tpu.dataset.dataset import DataFeedDesc as JDesc

import paddle_tpu_torch as tpt
from paddle_tpu_torch.core.scope import load_reference_scope
from paddle_tpu_torch.dataset import native as tnative
from paddle_tpu_torch.dataset.dataset import DataFeedDesc as TDesc

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
WD = dict(vocab=200, dim=4, slots=3, dense_dim=5, fc_sizes=(8, 8), lr=1e-2)
N, B = 96, 32

TEXT = (b"2 7 18446744073709551615 1 0.5 3 1 2 3\n"
        b"\n"
        b"1 0 2 -1.25 3e-2 1 9\t\r\n"
        b"3 4 5 6 1 1e10 2 8 8\n")
TYPES = ["uint64", "float", "uint64"]


def _parsed(values, lengths):
    return [v.tolist() for v in values], lengths.tolist(), \
        [str(v.dtype) for v in values]


def test_parsers_equal_jax_parse_multislot():
    """The native parser (built with the host compiler) and the plain one
    read the same values, lengths and dtypes as the JAX package."""
    assert tnative.using_native()
    want = _parsed(*jnative.parse_multislot(TEXT, TYPES))
    before = dict(tnative.PARSES)
    assert _parsed(*tnative.parse_multislot(TEXT, TYPES)) == want
    assert tnative.PARSES["native"] == before["native"] + 1
    assert _parsed(*tnative._parse_python(TEXT, TYPES)) == want
    assert tnative.PARSES["python"] == before["python"] + 1


@pytest.mark.parametrize("bad", [b"0 1\n", b"1 5 1\n", b"1 5 x 1.0\n",
                                 b"1 5 1 2.0 9\n"])
def test_malformed_text_raises_in_both_parsers(bad):
    types = ["uint64", "float"]
    with pytest.raises(ValueError):
        jnative.parse_multislot(bad, types)
    with pytest.raises(ValueError):
        tnative.parse_multislot(bad, types)
    with pytest.raises(ValueError):
        tnative._parse_python(bad, types)


def test_data_feed_desc_round_trip(tmp_path):
    proto = tmp_path / "feed.prototxt"
    proto.write_text(
        'name: "MultiSlotDataFeed"\nbatch_size: 2\nmulti_slot_desc {\n'
        '  slots { name: "words" type: "uint64" is_dense: false '
        "is_used: false }\n"
        '  slots { name: "dense_f" type: "float" is_dense: false '
        "is_used: false }\n}\n")
    descs = [D(str(proto)) for D in (JDesc, TDesc)]
    for d in descs:
        d.set_batch_size(4)
        d.set_use_slots(["words", "dense_f"])
        d.set_dense_slots(["dense_f"])
        d.set_pipe_command("cat")
        with pytest.raises(ValueError):
            d.set_use_slots(["nope"])
    assert descs[0].desc() == descs[1].desc()
    again = tmp_path / "again.prototxt"
    again.write_text(descs[1].desc())
    assert TDesc(str(again)).desc() == descs[1].desc()
    ds = descs[1].apply_to(tpt.dataset.DatasetFactory().create_dataset())
    assert ds._batch_size == 4
    assert [(s.name, s.type, s.is_dense) for s in ds._slots] == \
        [("words", "uint64", False), ("dense_f", "float", True)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """N instances of the small Wide&Deep in 3 files, written by the port's
    generator (its lines equal the JAX generator's)."""
    import paddle_tpu.dataset.dataset as jds
    root = tmp_path_factory.mktemp("wd")
    paths = chip_smoke.write_wd_files(tpt.dataset, str(root), n=N, files=3,
                                      slots=WD["slots"], vocab=WD["vocab"],
                                      dense_dim=WD["dense_dim"])
    jroot = tmp_path_factory.mktemp("wd_jax")
    jpaths = chip_smoke.write_wd_files(jds, str(jroot), n=N, files=3,
                                       slots=WD["slots"], vocab=WD["vocab"],
                                       dense_dim=WD["dense_dim"])
    for p, q in zip(paths, jpaths):
        assert open(p).read() == open(q).read()
    return paths


def _jax_program():
    """The program in the JAX package's static mode (its layers are
    dual-mode, dygraph by default)."""
    enable_static()
    try:
        return chip_smoke.build_wd_program(jpt, **WD)
    finally:
        disable_static()


def _programs():
    return _jax_program(), chip_smoke.build_wd_program(tpt, **WD)


def _batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("kind", ["InMemoryDataset", "QueueDataset"])
def test_batches_equal_jax(files, kind):
    """The same files and shuffle seed give the JAX package's batches,
    bitwise: padded ids, ``<slot>@len``, dense features and labels."""
    (jm, _, jfeeds, _), (tm, _, tfeeds, _) = _programs()
    want = list(chip_smoke.wd_dataset(jpt, jfeeds, files, B, kind))
    got = list(chip_smoke.wd_dataset(tpt, tfeeds, files, B, kind))
    _batches_equal(got, want)
    assert set(want[0]) >= {"C0", "C0@len", "dense", "label"}


@pytest.mark.parametrize("kind", ["InMemoryDataset", "QueueDataset"])
@pytest.mark.parametrize("drop_last", [False, True])
def test_ragged_batches_equal_jax(tmp_path, kind, drop_last):
    """Slots of 1-4 ids an instance and a 3-wide dense slot, 3 files of 7
    instances, batches of 5 across file boundaries: the padded ids,
    lengths and dense rows equal the JAX package's, bitwise."""
    rng = np.random.default_rng(12)
    paths = []
    for f in range(3):
        lines = []
        for _ in range(7):
            a = rng.integers(0, 2 ** 40, rng.integers(1, 5))
            d = rng.standard_normal(3).astype(np.float32)
            c = rng.integers(0, 9, rng.integers(1, 3))
            lines.append(" ".join([str(len(a)), *map(str, a), "3",
                                   *map(str, d), str(len(c)),
                                   *map(str, c)]))
        paths.append(str(tmp_path / f"part-{f}"))
        with open(paths[-1], "w") as out:
            out.write("\n".join(lines) + "\n")
    out = {}
    for pt, slot in ((tpt, tpt.dataset.Slot),
                     (jpt, jpt.dataset.dataset.Slot)):
        ds = pt.dataset.DatasetFactory().create_dataset(kind)
        ds._slots = [slot("a", "uint64"), slot("d", "float", True),
                     slot("c", "uint64")]
        ds.set_filelist(paths)
        ds.set_batch_size(5)
        ds._drop_last = drop_last
        if kind == "InMemoryDataset":
            ds.load_into_memory()
            ds.local_shuffle(4)
        out[pt.__name__] = list(ds)
    _batches_equal(out["paddle_tpu_torch"], out["paddle_tpu"])
    assert len(out["paddle_tpu"]) == (4 if drop_last else 5)


def test_trainer_sharding_and_memory(files):
    """set_trainer_num keeps file i where i % n == rank, as in the JAX
    package; global_shuffle on one rank is local_shuffle; release_memory
    drops the instances."""
    (_, _, jfeeds, _), (_, _, tfeeds, _) = _programs()
    for rank in range(2):
        got, want = [], []
        for pt, feeds, out in ((tpt, tfeeds, got), (jpt, jfeeds, want)):
            ds = pt.dataset.DatasetFactory().create_dataset("InMemoryDataset")
            ds.set_use_var(feeds)
            ds.set_filelist(files)
            ds.set_batch_size(B)
            ds.set_trainer_num(2, rank)
            ds.load_into_memory()
            ds.global_shuffle(seed=3)
            out.extend(ds)
            out.append(ds.get_memory_data_size())
            if pt is tpt:
                assert ds._my_files() == [f for i, f in enumerate(files)
                                          if i % 2 == rank]
                ds.release_memory()
                assert ds.get_memory_data_size() == 0
        assert got[-1] == want[-1]
        _batches_equal(got[:-1], want[:-1])
    with pytest.raises(ValueError):
        tpt.dataset.DatasetFactory().create_dataset("NoSuchDataset")


def _jax_epoch(files, infer=False, kind="InMemoryDataset", **kw):
    jm, js, jfeeds, jloss = _jax_program()
    scope, exe = JScope(), jpt.Executor()
    exe.run(js, scope=scope)
    state = {n: np.asarray(scope.find_var(n))
             for n in js.global_block.vars if scope.find_var(n) is not None}
    ds = chip_smoke.wd_dataset(jpt, jfeeds, files, B, kind)
    run = exe.infer_from_dataset if infer else exe.train_from_dataset
    out = run(jm, ds, scope=scope, fetch_list=[jloss], **kw)
    params = {v.name: np.asarray(scope.find_var(v.name))
              for v in jm.all_parameters()}
    return state, out, params


@pytest.fixture(scope="module")
def jax_epoch(files):
    return _jax_epoch(files)


def test_train_from_dataset_matches_jax(files, jax_epoch):
    """One epoch of the small Wide&Deep from the JAX startup state: each
    batch's loss and every parameter after against the JAX executor's
    train_from_dataset; the port's window 2, window 1 and the batches fed
    through run bitwise equal among themselves."""
    state, jout, jparams = jax_epoch
    tm, _, tfeeds, tloss = chip_smoke.build_wd_program(tpt, **WD)
    exe = tpt.Executor("cpu")
    ds = chip_smoke.wd_dataset(tpt, tfeeds, files, B)
    cpu = torch.device("cpu")
    w2, p2, _ = chip_smoke.dataset_epoch(exe, tm, ds, state, cpu, tloss, 2)
    w1, p1, _ = chip_smoke.dataset_epoch(exe, tm, ds, state, cpu, tloss, 1)
    fed, pf = chip_smoke.fed_epoch(exe, tm, ds, state, cpu, tloss)
    assert len(w2) == len(jout) == N // B
    np.testing.assert_allclose(w2, [float(np.asarray(r[0])) for r in jout],
                               **F32_TOL)
    for n, v in p2.items():
        np.testing.assert_allclose(v.numpy(), jparams[n], err_msg=n,
                                   **PARAM_TOL)
    assert w1 == w2 == fed
    assert chip_smoke.params_equal(p1, p2) and chip_smoke.params_equal(pf, p2)


def test_fetch_handler_and_print_period(files):
    """fetch_handler sees every print_period-th batch's fetches, as the
    JAX loop calls it."""
    seen = {"jax": [], "port": []}

    class Handler:
        def __init__(self, key):
            self.key = key

        def handler(self, fetched):
            seen[self.key].append(sorted(fetched))
    (jm, js, jfeeds, jloss), (tm, ts, tfeeds, tloss) = _programs()
    jscope, jexe = JScope(), jpt.Executor()
    jexe.run(js, scope=jscope)
    jexe.train_from_dataset(jm, chip_smoke.wd_dataset(jpt, jfeeds, files, B),
                            scope=jscope, fetch_list=[jloss], print_period=2,
                            fetch_handler=Handler("jax"))
    tscope, texe = tpt.Scope(), tpt.Executor("cpu")
    texe.run(ts, scope=tscope)
    out = texe.train_from_dataset(
        tm, chip_smoke.wd_dataset(tpt, tfeeds, files, B), scope=tscope,
        fetch_list=[tloss], print_period=2, fetch_handler=Handler("port"),
        keep_results=False)
    assert out is None
    assert seen["port"] == seen["jax"] == [[tloss.name]]


def test_infer_from_dataset_results_windows(files, jax_epoch):
    """infer_from_dataset runs the for_test clone (no parameter moves):
    keep_results=False returns None; FLAGS_dataset_results_window=2 keeps
    the last two batches; the losses match the JAX executor's."""
    state, _, _ = jax_epoch
    tm, _, tfeeds, tloss = chip_smoke.build_wd_program(tpt, **WD)
    scope = tpt.Scope()
    load_reference_scope(scope, state, "cpu")
    exe = tpt.Executor("cpu")
    ds = chip_smoke.wd_dataset(tpt, tfeeds, files, B, "QueueDataset")
    every = exe.infer_from_dataset(tm, ds, scope=scope, fetch_list=[tloss])
    assert exe.infer_from_dataset(tm, ds, scope=scope, fetch_list=[tloss],
                                  keep_results=False) is None
    for pt in (tpt, jpt):
        pt.set_flags({"FLAGS_dataset_results_window": 2})
    try:
        last = exe.infer_from_dataset(tm, ds, scope=scope,
                                      fetch_list=[tloss])
        _, jlast, _ = _jax_epoch(files, infer=True, kind="QueueDataset")
    finally:
        for pt in (tpt, jpt):
            pt.set_flags({"FLAGS_dataset_results_window": 0})
    assert [r[0] for r in last] == [r[0] for r in every[-2:]]
    np.testing.assert_allclose([float(r[0]) for r in last],
                               [float(np.asarray(r[0])) for r in jlast],
                               **F32_TOL)
    for v in tm.all_parameters():
        assert np.array_equal(scope.find_var(v.name).numpy(), state[v.name])


def test_dataset_loop_needs_a_dataset():
    with pytest.raises(ValueError, match="dataset is required"):
        tpt.Executor("cpu").train_from_dataset(tpt.Program())
    with pytest.raises(ValueError, match="dataset is required"):
        jpt.Executor().train_from_dataset(jpt.Program())
