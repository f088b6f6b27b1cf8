"""The port's PredictorPool against the JAX package's, on the CPU.

The pool serves the BERT encoder bundle of ``chip_smoke.build_bert_encoder``
(2 layers, H 64, 4 heads, vocab 100, S 16; saved by the JAX package) over
the port's CPU Predictor with a ladder: 4 client threads x 16 requests
of 1-5 rows, each answer held against the same request run alone through
the port's Predictor and against the JAX pool's answer on the same bundle
(fp32 atol 1e-5, rtol 1e-4: coalesced rows pass through other matrix
shapes than the request alone, so no bitwise claim). Then the bounded
queue (ServingQueueFull), shedding at admit (DeadlineBurned), the
supervisor's restart of a crashed loop (PoolRestarted), a failing batch
retried request by request, and close.
"""
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import inference as JI
from paddle_tpu import serving as jserving

from paddle_tpu_torch import inference as TI
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.monitor import reset_all, stat_get

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)

F32 = dict(atol=1e-5, rtol=1e-4)
SMALL = dict(layers_n=2, H=64, heads=4, FF=128, vocab=100, max_pos=32,
             types=2, S=16)
THREADS, PER_THREAD = 4, 16


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    import jax.numpy as jnp
    d = str(tmp_path_factory.mktemp("bundle"))
    main, _, out = chip_smoke.build_bert_encoder(jpt, **SMALL)
    scope = jpt.Scope()
    for k, v in chip_smoke.bert_encoder_state(main).items():
        scope.set(k, jnp.asarray(v))
    jpt.io.save_inference_model(d, list(chip_smoke.INFER_FEEDS), [out],
                                jpt.Executor(), main_program=main,
                                scope=scope)
    return d


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    return [chip_smoke.bert_encoder_feed(int(rng.integers(1, 6)), SMALL,
                                         seed=seed * 1000 + i, lo=4)
            for i in range(n)]


def _port_config(d, buckets="pow2:16"):
    cfg = TI.Config(d)
    cfg.disable_gpu()
    if buckets is not None:
        cfg.switch_shape_bucketing(True, buckets=buckets)
    return cfg


def _serve_threads(pool, reqs):
    outs = [None] * len(reqs)

    def client(t):
        for i in range(t, len(reqs), THREADS):
            outs[i] = pool.run(reqs[i], timeout=120)[0]
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outs


def test_pool_answers_equal_alone_and_the_jax_pool(bundle):
    reqs = _requests(THREADS * PER_THREAD)
    alone = TI.create_predictor(_port_config(bundle, None))
    want = [alone.run(r)[0] for r in reqs]
    reset_all()
    with tserving.serve(_port_config(bundle), max_batch=16,
                        batch_timeout_ms=5.0) as pool:
        report = pool.warmup([f[:1] for f in reqs[0]])
        assert sorted(report) == [1, 2, 4, 8, 16]
        got = _serve_threads(pool, reqs)
    jcfg = JI.Config(bundle)
    jcfg.switch_shape_bucketing(True, buckets="pow2:16")
    with jserving.PredictorPool(jcfg, max_batch=16,
                                batch_timeout_ms=5.0) as jpool:
        jgot = _serve_threads(jpool, reqs)
    for r, g, w, j in zip(reqs, got, want, jgot):
        assert g.shape == (r[0].shape[0], SMALL["S"], SMALL["H"])
        np.testing.assert_allclose(g, w, **F32)
        np.testing.assert_allclose(g, np.asarray(j), **F32)
    rows = sum(r[0].shape[0] for r in reqs)
    assert stat_get("STAT_serving_requests") == len(reqs)
    assert stat_get("STAT_serving_batched_rows") == rows
    assert 1 <= stat_get("STAT_serving_batches") <= len(reqs)
    assert stat_get("STAT_serving_batch_errors") == 0
    # every batch padded onto the ladder the warmup ran: no cold
    # signature, and no graph on the CPU
    assert stat_get("STAT_predictor_bucket_cold") == 0
    assert stat_get("STAT_predictor_bucket_hit") == \
        stat_get("STAT_serving_batches")
    assert stat_get("STAT_predictor_graph_capture") == 0


def test_compatible_requests_coalesce_into_one_batch(bundle):
    pool = tserving.PredictorPool(_port_config(bundle), max_batch=32,
                                  batch_timeout_ms=50.0, _start=False)
    reqs = _requests(4, seed=1)
    reset_all()
    futs = [pool.submit(r) for r in reqs]
    pool.start()
    outs = [f.result(timeout=60)[0] for f in futs]
    pool.close()
    assert stat_get("STAT_serving_batches") == 1
    alone = TI.create_predictor(_port_config(bundle, None))
    for r, o in zip(reqs, outs):
        np.testing.assert_allclose(o, alone.run(r)[0], **F32)
    stages = [s for s, _ in futs[0].trace.stages]
    assert stages == ["submit", "admit", "batch_join", "dispatch",
                      "execute", "fetch", "done"]
    assert futs[0].trace.fields["rows"] == reqs[0][0].shape[0]


def test_full_queue_raises_serving_queue_full_and_close_fails_queued(bundle):
    pool = tserving.PredictorPool(_port_config(bundle), queue_depth=2,
                                  _start=False)
    r = _requests(1)[0]
    reset_all()
    f1, f2 = pool.submit(r), pool.submit(r)
    with pytest.raises(tserving.ServingQueueFull) as info:
        pool.submit(r, timeout=0.05)
    assert info.value.queue_depth == 2 and info.value.retry_after_s > 0
    assert stat_get("STAT_serving_rejected") == 1
    pool.close()
    for f in (f1, f2):
        with pytest.raises(RuntimeError, match="closed"):
            f.result(timeout=1.0)
    with pytest.raises(RuntimeError, match="closed"):
        pool.submit(r)


def test_deadline_burned_while_waiting_and_at_admit(bundle):
    pool = tserving.PredictorPool(_port_config(bundle), queue_depth=1,
                                  _start=False)
    r = _requests(1)[0]
    reset_all()
    pool.submit(r)
    with pytest.raises(tserving.DeadlineBurned) as info:
        pool.submit(r, deadline=0.02)
    assert info.value.trace_id
    pool.close()
    pool = tserving.PredictorPool(_port_config(bundle), _start=False)
    with pytest.raises(tserving.DeadlineBurned):
        pool.submit(r, deadline=0.0)
    assert stat_get("STAT_serving_shed_at_admit") == 2
    pool.close()


class _Crash(BaseException):
    """Escapes the batch's error isolation, as a fault of the loop."""


def test_crashed_loop_is_restarted_and_the_batch_gets_pool_restarted(
        bundle, monkeypatch):
    pool = tserving.PredictorPool(_port_config(bundle), batch_timeout_ms=1.0)
    r = _requests(1, seed=3)[0]
    real = pool.predictor.run
    calls = []

    def run(feeds):
        calls.append(1)
        if len(calls) == 1:
            raise _Crash("boom")
        return real(feeds)
    monkeypatch.setattr(pool.predictor, "run", run)
    reset_all()
    with pytest.raises(tserving.PoolRestarted) as info:
        pool.run(r, timeout=60)
    assert isinstance(info.value.cause, _Crash) and info.value.trace_id
    out = pool.run(r, timeout=60)[0]
    assert stat_get("STAT_serving_restarts") == 1
    np.testing.assert_allclose(
        out, TI.create_predictor(_port_config(bundle, None)).run(r)[0], **F32)
    pool.close()


def test_a_failing_batch_is_retried_request_by_request(bundle, monkeypatch):
    """A batch whose run raises is run again request by request: the bad
    request gets its error, its batch-mates their own answers."""
    pool = tserving.PredictorPool(_port_config(bundle), max_batch=32,
                                  batch_timeout_ms=50.0, _start=False)
    good = _requests(2, seed=4)
    bad = [f.copy() for f in good[0]]
    bad[0][0, 0, 0] = 10 ** 6  # an id past the table
    real = pool.predictor.run

    def run(feeds):
        if int(np.max(feeds[0])) >= SMALL["vocab"]:
            raise IndexError("id past the table")
        return real(feeds)
    monkeypatch.setattr(pool.predictor, "run", run)
    reset_all()
    futs = [pool.submit(good[0]), pool.submit(bad), pool.submit(good[1])]
    pool.start()
    with pytest.raises(IndexError):
        futs[1].result(timeout=60)
    alone = TI.create_predictor(_port_config(bundle, None))
    for f, req in zip((futs[0], futs[2]), good):
        np.testing.assert_allclose(f.result(timeout=60)[0],
                                   alone.run(req)[0], **F32)
    assert stat_get("STAT_serving_batch_errors") == 1
    pool.close()


def test_pool_rejects_mismatched_feeds_and_labels(bundle):
    pool = tserving.PredictorPool(_port_config(bundle), _start=False)
    r = _requests(1)[0]
    with pytest.raises(ValueError, match="expected 4 feeds"):
        pool.submit(r[:3])
    with pytest.raises(ValueError, match="shared leading"):
        pool.submit([r[0], r[1][:1], r[2], r[3]])
    with pytest.raises(NotImplementedError, match="A7"):
        pool.submit(r, tenant="a")
    pool.close()
