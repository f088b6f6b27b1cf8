"""Sparse embeddings on the port against the JAX package, on the CPU.

``SelectedRows`` and its merge (the drop marker kept last and dropped by
``to_dense``), the sparse gradient of ``F.embedding(sparse=True)`` with a
``padding_idx``, each eager optimizer's sparse rule for 3 steps against
the JAX eager optimizer given the same ``SelectedRows`` gradient (as
``tests/test_selected_rows.py`` drives it), lazy Adam's untouched rows,
the clips and ``GradScaler`` on sparse gradients, the two SelectedRows
ops, and a small Wide&Deep (vocab 200, 4 slots, dim 4, fc [16, 16]) for 3
Adam steps from the JAX model's state. Rows are compared exactly; values
in fp32 arithmetic of the same order at RULE_TOL, and at F32_TOL where
the two packages sum in other orders (the merge, the MLP).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as J
from paddle_tpu.amp import GradScaler as JScaler
from paddle_tpu.core.registry import REGISTRY as JREG
from paddle_tpu.core.registry import LowerCtx as JCtx
from paddle_tpu.core.selected_rows import SelectedRows as JSR
from paddle_tpu.dygraph import Tensor
from paddle_tpu.dygraph.tape import run_op
from paddle_tpu.jit import state_of
from paddle_tpu.models.wide_deep import WideDeep as JWideDeep

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
import paddle_tpu_torch.optimizer as T
from paddle_tpu_torch import monitor
from paddle_tpu_torch.amp import GradScaler as TScaler
from paddle_tpu_torch.core.registry import REGISTRY as TREG
from paddle_tpu_torch.core.selected_rows import SelectedRows as TSR
from paddle_tpu_torch.jit import load_reference_state
from paddle_tpu_torch.layers.helper import seed as tseed
from paddle_tpu_torch.models.wide_deep import WideDeep as TWideDeep

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)

RULE_TOL = dict(rtol=1e-6, atol=1e-7)
F32_TOL = dict(rtol=1e-5, atol=1e-6)
H, D = 12, 3


def _sr_case(seed=0, n=9, marker=True):
    """Rows with repeats (and a marker when ``marker``), values [n, D]."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, H, n)
    if marker:
        rows[2] = H
    return rows.astype(np.int64), rng.standard_normal((n, D)).astype(
        np.float32)


def _jax_merged(rows, vals):
    m = JSR(rows, vals, H).merged()
    return np.asarray(m.rows), np.asarray(m.values)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_keeps_the_jax_contract(seed):
    rows, vals = _sr_case(seed)
    got = TSR(rows, vals, H).merged()
    want_rows, want_vals = _jax_merged(rows, vals)
    np.testing.assert_array_equal(got.rows.numpy(), want_rows)
    np.testing.assert_allclose(got.values.numpy(), want_vals, **F32_TOL)
    assert got.merged() is got
    np.testing.assert_allclose(got.to_dense().numpy(),
                               np.asarray(JSR(rows, vals, H).to_dense()),
                               **F32_TOL)
    # the same length, sorted, unique but for the markers, markers last
    r = got.rows.numpy()
    assert len(r) == len(rows) and (np.diff(r) >= 0).all()
    real = r[r < H]
    assert len(set(real)) == len(real)


def test_selected_rows_arithmetic():
    rows, vals = _sr_case(3, marker=False)
    a = TSR(rows, vals, H)
    j = JSR(rows, vals, H)
    np.testing.assert_allclose((a + a).numpy(), (j + j).numpy(), **F32_TOL)
    dense = np.ones((H, D), np.float32)
    np.testing.assert_allclose((a + torch.from_numpy(dense)).numpy(),
                               np.asarray(j + dense), **F32_TOL)
    np.testing.assert_allclose((a * 2.0).numpy(), (j * 2.0).numpy(),
                               **F32_TOL)
    assert (a + a).rows.shape[0] == 2 * len(rows)


def test_merge_is_bitwise_repeatable():
    rows, vals = _sr_case(4, n=4000)
    a = TSR(rows, vals, H).merged()
    b = TSR(rows, vals, H).merged()
    assert torch.equal(a.rows, b.rows) and torch.equal(a.values, b.values)


def test_sparse_embedding_gradient_with_padding_idx():
    """The JAX sparse lookup's SelectedRows and the port's sparse COO
    gradient, as a SelectedRows, merged: the same rows, the padding id a
    marker; the dense gradient's padding row 0."""
    rng = np.random.default_rng(5)
    w0 = rng.standard_normal((H, D)).astype(np.float32)
    ids = rng.integers(0, H, (4, 5)).astype(np.int64)
    ids[0, :2] = 7
    jw = Tensor(jnp.asarray(w0), stop_gradient=False, trainable=True)
    out = JF.embedding(Tensor(jnp.asarray(ids)), jw, padding_idx=7,
                       sparse=True)
    run_op("reduce_sum", {"X": [out * out]},
           {"reduce_all": True})["Out"][0].backward()
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    (TF.embedding(torch.from_numpy(ids), tw, padding_idx=7,
                  sparse=True) ** 2).sum().backward()
    assert tw.grad.layout == torch.sparse_coo
    got = TSR.from_grad(tw.grad, 7)
    want = jw.grad
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               **RULE_TOL)
    gm, wm = got.merged(), want.merged()
    np.testing.assert_array_equal(gm.rows.numpy(), np.asarray(wm.rows))
    np.testing.assert_allclose(gm.values.numpy(), np.asarray(wm.values),
                               **F32_TOL)
    dense = got.to_dense().numpy()
    assert (dense[7] == 0).all()
    np.testing.assert_allclose(dense, want.numpy(), **F32_TOL)


def test_sparse_lookup_with_padding_idx_plus_a_dense_term():
    """A weight read by a sparse lookup with padding_idx=7 and by a dense
    term (sum(w * w)): its gradient, the sparse part with the padding row
    dropped plus the dense part, equals the JAX package's (ROADMAP.md C5:
    the padding entry of the port's COO gradient is 0, so a dense
    accumulation adds nothing at row 7)."""
    rng = np.random.default_rng(6)
    w0 = rng.standard_normal((H, D)).astype(np.float32)
    lin = rng.standard_normal((4, 5, D)).astype(np.float32)
    ids = rng.integers(0, H, (4, 5)).astype(np.int64)
    ids[0, :2] = 7
    ids[3, 4] = 7
    jw = Tensor(jnp.asarray(w0), stop_gradient=False, trainable=True)
    out = JF.embedding(Tensor(jnp.asarray(ids)), jw, padding_idx=7,
                       sparse=True)
    loss = run_op("reduce_sum", {"X": [out * Tensor(jnp.asarray(lin))]},
                  {"reduce_all": True})["Out"][0] + run_op(
        "reduce_sum", {"X": [jw * jw]}, {"reduce_all": True})["Out"][0]
    loss.backward()
    want = jw.grad
    want = np.asarray(want.to_dense() if isinstance(want, JSR) else want)
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    ((TF.embedding(torch.from_numpy(ids), tw, padding_idx=7, sparse=True)
      * torch.from_numpy(lin)).sum() + (tw * tw).sum()).backward()
    got = tw.grad.to_dense().numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_allclose(got[7], 2 * w0[7], **F32_TOL)


def test_only_a_leaf_weight_gets_a_sparse_gradient():
    w = torch.nn.Parameter(torch.randn(H, D))
    ids = torch.tensor([[1, 2]])
    TF.embedding(ids, w * 2.0, sparse=True).sum().backward()
    assert w.grad.layout == torch.strided
    emb = tnn.Embedding(H, D, sparse=True, device="cpu")
    emb(ids).sum().backward()
    assert emb.weight.grad.layout == torch.sparse_coo


# the optimizers whose sparse rule (or densify) is held against JAX
SPARSE_RULES = {
    "sgd": ("SGD", dict(learning_rate=0.1)),
    "momentum": ("Momentum", dict(learning_rate=0.1, momentum=0.9)),
    "nesterov": ("Momentum", dict(learning_rate=0.1, momentum=0.9,
                                  use_nesterov=True)),
    "adam": ("Adam", dict(learning_rate=0.1)),
    "adamw": ("AdamW", dict(learning_rate=0.1, weight_decay=0.05)),
    "adagrad": ("Adagrad", dict(learning_rate=0.1,
                                initial_accumulator_value=0.1)),
    "lamb": ("Lamb", dict(learning_rate=0.1, lamb_weight_decay=0.02)),
    "adamax": ("Adamax", dict(learning_rate=0.1)),
}
DENSIFIED = {"lamb", "adamax"}


@pytest.mark.parametrize("rule", sorted(SPARSE_RULES))
def test_sparse_rule_matches_jax(rule):
    """Three steps of a SelectedRows gradient (repeated rows and a marker)
    into the JAX eager optimizer and into the port's as a sparse COO
    gradient of the same entries: the parameter after each step, and for
    the lazy rules the rows never touched bitwise unchanged."""
    name, kw = SPARSE_RULES[rule]
    rng = np.random.default_rng(6)
    w0 = rng.standard_normal((H, D)).astype(np.float32)
    jp = Tensor(jnp.asarray(w0), stop_gradient=False, trainable=True)
    tp = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    tp._sparse_padding_idx = 0  # row 0 plays the padding id (the marker)
    jopt = getattr(J, name)(parameters=[jp], **kw)
    topt = getattr(T, name)(parameters=[tp], **kw)
    touched = set()
    monitor.reset_all()
    for step in range(3):
        rows, vals = _sr_case(10 + step, n=8, marker=False)
        rows[1] = 0
        touched |= set(rows.tolist()) - {0}
        jrows = np.where(rows == 0, H, rows)
        jp.grad = JSR(jrows, vals, H)
        tp.grad = torch.sparse_coo_tensor(torch.from_numpy(rows[None]),
                                          torch.from_numpy(vals), (H, D))
        jopt.step()
        topt.step()
        tol = F32_TOL if rule in DENSIFIED else RULE_TOL
        np.testing.assert_allclose(tp.detach().numpy(),
                                   np.asarray(jp.value), **tol,
                                   err_msg=f"{rule} step {step + 1}")
    if rule in DENSIFIED:
        assert monitor.stat_get("STAT_optimizer_densified_update") == 3
        return
    assert monitor.stat_get("STAT_optimizer_sparse_update") == 3
    assert monitor.stat_get("STAT_optimizer_densified_update") == 0
    untouched = sorted(set(range(H)) - touched)
    assert untouched and 0 in untouched
    assert torch.equal(tp.detach()[untouched],
                       torch.from_numpy(w0)[untouched])


def test_lazy_adam_moments_move_only_on_touched_rows():
    w = torch.nn.Parameter(torch.zeros(H, D))
    opt = T.Adam(0.1, parameters=[w])
    w.grad = torch.sparse_coo_tensor(torch.tensor([[2, 5, 2]]),
                                     torch.ones(3, D), (H, D))
    opt.step()
    st = opt.accumulators(w)
    moved = (st["moment1"] != 0).any(1).nonzero().flatten().tolist()
    assert moved == [2, 5]
    np.testing.assert_allclose(float(st["beta1_pow"]), 0.9 * 0.9, rtol=1e-6)


def test_regularization_is_skipped_for_sparse_gradients_with_a_warning():
    w0 = np.ones((H, D), np.float32)
    tp = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = T.SGD(0.1, parameters=[tp], regularization=T.L2Decay(0.5))
    tp.grad = torch.sparse_coo_tensor(torch.tensor([[1]]), torch.ones(1, D),
                                      (H, D))
    with pytest.warns(UserWarning, match="regularization is skipped"):
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy()[1], 1.0 - 0.1)


@pytest.mark.parametrize("clip", ["value", "norm", "global"])
def test_clips_merge_sparse_gradients_as_jax(clip):
    """A clip over one sparse and one dense gradient, then SGD: the JAX
    clip merges the SelectedRows first and takes its norm over the
    merged values."""
    rng = np.random.default_rng(7)
    rows, vals = _sr_case(8, marker=False)
    vals *= 3.0
    dense_g = rng.standard_normal((4, 2)).astype(np.float32)
    make = {"value": lambda M: M.GradientClipByValue(0.5),
            "norm": lambda M: M.GradientClipByNorm(1.0),
            "global": lambda M: M.GradientClipByGlobalNorm(1.0)}[clip]
    w0 = rng.standard_normal((H, D)).astype(np.float32)
    d0 = rng.standard_normal((4, 2)).astype(np.float32)
    jw, jd = (Tensor(jnp.asarray(a), stop_gradient=False, trainable=True)
              for a in (w0, d0))
    tw, td = (torch.nn.Parameter(torch.from_numpy(a.copy()))
              for a in (w0, d0))
    jopt = J.SGD(0.1, parameters=[jw, jd], grad_clip=make(J))
    topt = T.SGD(0.1, parameters=[tw, td], grad_clip=make(T))
    jw.grad, jd.grad = JSR(rows, vals, H), jnp.asarray(dense_g)
    tw.grad = torch.sparse_coo_tensor(torch.from_numpy(rows[None]),
                                      torch.from_numpy(vals), (H, D))
    td.grad = torch.from_numpy(dense_g)
    jopt.step()
    topt.step()
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw.value),
                               **F32_TOL)
    np.testing.assert_allclose(td.detach().numpy(), np.asarray(jd.value),
                               **F32_TOL)


@pytest.mark.parametrize("overflow", [False, True])
def test_grad_scaler_unscales_sparse_values(overflow):
    rows, vals = _sr_case(9, marker=False)
    if overflow:
        vals[3, 1] = np.inf
    w0 = np.ones((H, D), np.float32)
    jw = Tensor(jnp.asarray(w0), stop_gradient=False, trainable=True)
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    jopt, topt = J.SGD(0.1, parameters=[jw]), T.SGD(0.1, parameters=[tw])
    js, ts = JScaler(init_loss_scaling=8.0), TScaler(init_loss_scaling=8.0)
    jw.grad = JSR(rows, vals * 8.0, H)
    tw.grad = torch.sparse_coo_tensor(torch.from_numpy(rows[None]),
                                      torch.from_numpy(vals * 8.0), (H, D))
    js.minimize(jopt, None)
    ts.minimize(topt, None)
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw.value),
                               **F32_TOL)
    if overflow:
        assert torch.equal(tw.detach(), torch.from_numpy(w0))
    else:
        np.testing.assert_allclose(tw.grad._values().numpy(), vals,
                                   **RULE_TOL)
    assert ts.get_scale() == js.get_scale()


def test_the_selected_rows_ops_match_jax():
    rows, vals = _sr_case(11)
    jin = {"X": [JSR(rows, vals, H)]}
    tin = {"X": [TSR(rows, vals, H)]}
    jm = JREG.get("merge_selected_rows").lower(JCtx(), jin, {})["Out"][0]
    tm = TREG.get("merge_selected_rows").lower(None, tin, {})["Out"][0]
    np.testing.assert_array_equal(tm.rows.numpy(), np.asarray(jm.rows))
    np.testing.assert_allclose(tm.values.numpy(), np.asarray(jm.values),
                               **F32_TOL)
    jd = JREG.get("get_tensor_from_selected_rows").lower(
        JCtx(), jin, {})["Out"][0]
    td = TREG.get("get_tensor_from_selected_rows").lower(
        None, tin, {})["Out"][0]
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **F32_TOL)
    with pytest.raises(TypeError):
        TREG.get("merge_selected_rows").lower(None, {"X": [torch.ones(2)]},
                                              {})


def test_bce_with_logits_and_one_hot_match_jax():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((6, 1)).astype(np.float32) * 4
    y = (rng.random((6, 1)) > 0.5).astype(np.float32)
    for red in ("mean", "sum", "none"):
        want = JF.binary_cross_entropy_with_logits(
            Tensor(jnp.asarray(x)), Tensor(jnp.asarray(y)), reduction=red)
        got = TF.binary_cross_entropy_with_logits(
            torch.from_numpy(x), torch.from_numpy(y), reduction=red)
        np.testing.assert_allclose(got.numpy(), np.asarray(want.value),
                                   **RULE_TOL)
    ids = np.array([[0, 3, 5], [2, 7, 1]], np.int64)
    want = JF.one_hot(Tensor(jnp.asarray(ids)), 6)
    np.testing.assert_array_equal(TF.one_hot(torch.from_numpy(ids), 6).numpy(),
                                  np.asarray(want.value))


WD_SMALL = dict(sparse_feature_number=200, sparse_feature_dim=4,
                dense_feature_dim=13, num_sparse_slots=4, fc_sizes=[16, 16])


def _wd_batch(step, b=8):
    rng = np.random.default_rng(100 + step)
    ids = ((rng.zipf(1.2, (b, 4)) - 1) % 200).astype(np.int64)
    dense = rng.standard_normal((b, 13)).astype(np.float32)
    label = (rng.random((b, 1)) > 0.5).astype(np.float32)
    return ids, dense, label


def test_wide_deep_trains_as_jax():
    """The small Wide&Deep with a sparse table, 3 Adam(1e-2) steps from
    the JAX model's state: each step's loss and every parameter after;
    the table's gradient never densified, its untouched rows bitwise
    unchanged."""
    jmodel = JWideDeep(**WD_SMALL, distributed_embedding=jnn.Embedding(
        200, 4, sparse=True))
    state = {n: np.asarray(v) for n, v in state_of(jmodel).items()}
    tmodel = TWideDeep(**WD_SMALL, distributed_embedding=tnn.Embedding(
        200, 4, sparse=True, device="cpu"), device="cpu")
    load_reference_state(tmodel, state)
    jopt = J.Adam(1e-2, parameters=jmodel.parameters())
    topt = T.Adam(1e-2, parameters=list(tmodel.parameters()))
    touched = set()
    monitor.reset_all()
    for step in range(3):
        ids, dense, label = _wd_batch(step)
        touched |= set(ids.flatten().tolist())
        jloss = jmodel.loss(jmodel(Tensor(jnp.asarray(ids)),
                                   Tensor(jnp.asarray(dense))),
                            Tensor(jnp.asarray(label)))
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
        tloss = tmodel.loss(tmodel(torch.from_numpy(ids),
                                   torch.from_numpy(dense)),
                            torch.from_numpy(label))
        tloss.backward()
        assert tmodel.embedding.weight.grad.layout == torch.sparse_coo
        topt.step()
        topt.clear_grad()
        np.testing.assert_allclose(float(tloss), float(np.asarray(
            jloss.value)), **F32_TOL)
    want = {n: np.asarray(v) for n, v in state_of(jmodel).items()}
    for n, t in tmodel.named_parameters():
        np.testing.assert_allclose(t.detach().numpy(), want[n], rtol=1e-4,
                                   atol=1e-6, err_msg=n)
    assert monitor.stat_get("STAT_optimizer_sparse_update") == 3
    assert monitor.stat_get("STAT_optimizer_densified_update") == 0
    table = tmodel.embedding.weight.detach()
    untouched = sorted(set(range(200)) - touched)
    assert torch.equal(table[untouched],
                       torch.from_numpy(state["embedding.weight"])[untouched])


def test_wide_deep_defaults_match_jax():
    tseed(0)
    jnames = {n: np.asarray(v).shape for n, v in
              state_of(JWideDeep()).items()}
    tnames = {n: tuple(t.shape) for n, t in
              TWideDeep(device="cpu").named_parameters()}
    assert jnames == tnames
    assert tnames["embedding.weight"] == (100000, 16)
