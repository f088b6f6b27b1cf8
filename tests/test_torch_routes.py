"""The port's attention route and its layer-norm instances, against the JAX
package, on the CPU.

``nn/transformer.py`` sends an attention whose head dim the JAX router
sends to its composed path (any but 64, 128 and 256) to a composed path
on the card, and every other one to the flash kernels, which launch (head
dims 64 and 128 in fp32, bf16 and fp16) or raise. The layer-norm kernels take widths up to ``MAX_FEATURES`` and x in
fp32, bf16 and fp16, and refuse the rest (``takes``). The predicates are
held over head dim or width x dtype x device type; the composed attention
is forced here on the CPU and held, with the CPU's own route, against the
JAX package on the same numpy inputs with parameters carried by name, and
so are the plain versions of the wide and fp16 layer norms.
chip_smoke.py runs the same cases on the card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import nn as jnn
from paddle_tpu.dygraph import Tensor, seed
from paddle_tpu.jit import functional_call, state_of
from paddle_tpu.kernels import layer_norm as jln

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.jit import load_reference_state
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import layer_norm as tln
from paddle_tpu_torch.layers import helper as thelper
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import transformer as ttr

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)

F32, BF16, F16, F64 = torch.float32, torch.bfloat16, torch.float16, \
    torch.float64
# fp32 on both sides, different summation orders
F32_TOL = dict(atol=2e-5, rtol=2e-5)


def _rand(shape, s=0):
    return np.random.RandomState(s).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the predicates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 96, 128, 256])
def test_attention_route(head_dim, device_type):
    # the JAX router's head dims go to the flash kernels on the card, which
    # have instances at 64, 128 and 256 in fp32, bf16 and fp16
    if device_type == "cpu":
        want = "reference"
    elif head_dim in (64, 128, 256):
        want = "flash"
    else:
        want = "composed"
    assert ttr.attention_route(head_dim, device_type) == want


@pytest.mark.parametrize("head_dim,q_dtype,kv_dtype", [
    (64, F32, BF16), (128, F16, BF16), (64, F64, F64)])
def test_flash_kernel_refuses_what_has_no_instance(head_dim, q_dtype,
                                                   kv_dtype):
    # mixed dtypes and fp64 take the flash route on the card and meet its
    # wrapper's refusal: no plain version runs there
    q = torch.zeros(1, 2, 8, head_dim, dtype=q_dtype)
    k = v = torch.zeros(1, 2, 8, head_dim, dtype=kv_dtype)
    with pytest.raises((TypeError, ValueError)):
        tfa._check(q, k, v)


@pytest.mark.parametrize("dtype", [F32, BF16, F16])
@pytest.mark.parametrize("head_dim", [64, 128, 256])
def test_flash_kernel_takes_each_dtype(head_dim, dtype):
    # every head dim the router sends to the kernels has an instance in
    # every dtype
    assert tfa.HEAD_DIMS == ttr.KERNEL_HEAD_DIMS
    q = k = v = torch.zeros(1, 2, 8, head_dim, dtype=dtype)
    tfa._check(q, k, v)


@pytest.mark.parametrize("dtype", [F32, BF16, F16, F64])
@pytest.mark.parametrize("features", [1, 768, 4096, 4097, 8192, 65536,
                                      65537])
def test_layer_norm_kernel_takes(features, dtype):
    want = dtype != F64 and features <= 65536
    assert tln.takes(dtype, features, F32, F32) == want
    assert tln.takes(dtype, features, dtype, dtype) == want


@pytest.mark.parametrize("x_dtype,g_dtype,b_dtype,want", [
    (BF16, BF16, BF16, True), (F16, F16, F16, True), (F16, F32, F32, True),
    (F32, BF16, BF16, False), (BF16, F16, F16, False),
    (F32, F32, BF16, False)])
def test_layer_norm_kernel_takes_parameter_dtypes(x_dtype, g_dtype, b_dtype,
                                                  want):
    # gamma and beta share fp32 or x's dtype
    assert tln.takes(x_dtype, 768, g_dtype, b_dtype) == want


# ---------------------------------------------------------------------------
# attention against the JAX package
# ---------------------------------------------------------------------------

def _jax_value_and_grads(jl, state, x, w, mask):
    names = [n for n, _ in jl.named_parameters()]

    def loss_of(params, xv):
        out = functional_call(jl, {**state, **params}, Tensor(xv),
                              attn_mask=Tensor(mask), training=True)[0]
        return jnp.sum(out * w), out

    params = {n: jnp.asarray(state[n]) for n in names}
    (_, out), (gp, gx) = jax.value_and_grad(loss_of, argnums=(0, 1),
                                            has_aux=True)(params,
                                                          jnp.asarray(x))
    return np.asarray(out), {n: np.asarray(g) for n, g in gp.items()}, \
        np.asarray(gx)


# fp32 gradients of the two packages: each held to 1e-4 of its own largest
# element plus 1e-4 relative (test_torch_train.py's rule), with a 1e-7
# floor for rounding noise around exact zeros
def _assert_grad_close(got, want, name):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=1e-4 * scale + 1e-7,
                               rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("route", ["reference", "composed"])
@pytest.mark.parametrize("embed,heads", [(256, 8), (512, 2)])
def test_attention_without_a_kernel_matches_jax(embed, heads, route,
                                                monkeypatch):
    """MultiHeadAttention(256, 8) (head dim 32) and head dim 256: output,
    every parameter gradient and the input gradient, on the CPU's route
    and on the composed route (the card's route for head dim 32)."""
    if route == "composed":
        monkeypatch.setattr(ttr, "attention_route",
                            lambda *args: "composed")
    seed(11)
    jl = jnn.MultiHeadAttention(embed, heads)
    tl = tnn.MultiHeadAttention(embed, heads, device="cpu")
    state = {n: np.asarray(v) for n, v in state_of(jl).items()}
    load_reference_state(tl, state)
    x = _rand((2, 9, embed), 12)
    w = _rand((2, 9, embed), 13)
    lens = np.array([9, 4])
    m = (np.arange(9)[None, :] < lens[:, None]).astype(np.float32)
    mask = ((1.0 - m)[:, None, None, :] *
            np.finfo(np.float32).min).astype(np.float32)
    out_j, grads_j, gx_j = _jax_value_and_grads(jl, state, x, w, mask)

    tl.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    ttr.reset_attention_path_log()
    out_t = tl(xt, attn_mask=torch.from_numpy(mask))
    (out_t * torch.from_numpy(w)).sum().backward()
    assert ttr.attention_paths_taken() == [route]
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, **F32_TOL)
    params = dict(tl.named_parameters())
    assert set(params) == set(grads_j)
    largest = max(float(np.abs(g).max()) for g in grads_j.values())
    for n, p in params.items():
        if n == "k_proj.bias":
            # exactly 0 in exact arithmetic (it shifts every score of a row
            # by one constant, which softmax ignores): both packages hold
            # rounding noise, each under 1e-6 of the largest gradient
            for g in (p.grad.numpy(), grads_j[n]):
                assert float(np.abs(g).max()) <= 1e-6 * largest, n
            continue
        _assert_grad_close(p.grad.numpy(), grads_j[n], n)
    _assert_grad_close(xt.grad.numpy(), gx_j, "input")


@pytest.mark.parametrize("causal", [False, True])
def test_composed_attention_equals_the_reference_route(causal,
                                                       monkeypatch):
    """With seed dropout 0.1 in training and a causal mask: the composed
    route draws the same seed from the port's generator and drops the
    same probabilities (philox_keep_mask) as the flash route's plain
    version."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(2, 10, 4, 32).astype(np.float32))
               for _ in range(3))
    outs = {}
    for route in ("reference", "composed"):
        monkeypatch.setattr(ttr, "attention_route", lambda *args, r=route: r)
        thelper.seed(5)
        outs[route] = ttr._attention_core(q, k, v, None, 0.1, True, causal)
    torch.testing.assert_close(outs["composed"], outs["reference"],
                               atol=1e-6, rtol=1e-6)
    thelper.seed(5)
    undropped = ttr._attention_core(q, k, v, None, 0.0, True, causal)
    assert not torch.allclose(undropped, outs["composed"])


def test_composed_attention_follows_the_seed_pattern():
    # the composed probabilities are dropped where philox_keep_mask says
    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.randn(1, 6, 2, 32).astype(np.float32))
               for _ in range(3))
    thelper.seed(9)
    seed_drawn = tfa.draw_seed(thelper.default_generator())
    keep = tfa.philox_keep_mask(seed_drawn, 1, 2, 6, 6, 0.8)
    thelper.seed(9)
    got = ttr._composed_attention(q, k, v, None, 0.8, False, 32 ** -0.5)
    probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * 32 ** -0.5,
                          -1)
    want = torch.einsum("bhqk,bkhd->bqhd", probs * keep / 0.8, v)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# layer norm against the JAX package
# ---------------------------------------------------------------------------

def test_layer_norm_over_8192_features_matches_jax():
    """A width the wide-row kernels take: the plain version, forward and
    the gradients of x, gamma and beta, against the JAX layer_norm (its
    Pallas kernel in interpret mode at this lane-aligned width)."""
    rows, f = 16, 8192
    x, g, b, dy = _rand((rows, f), 1) * 2 + 0.5, _rand((f,), 2), \
        _rand((f,), 3), _rand((rows, f), 4)
    y_j, vjp = jax.vjp(lambda a, c, d: jln.layer_norm(a, c, d, 1e-5),
                       jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    dx_j, dg_j, db_j = vjp(jnp.asarray(dy))

    xt, gt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, g, b))
    TF.reset_layer_norm_path_log()
    y_t = TF.layer_norm(xt, f, gt, bt, 1e-5)
    y_t.backward(torch.from_numpy(dy))
    assert TF.layer_norm_paths_taken() == ["reference"]
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               **F32_TOL)
    for name, got, want in (("dx", xt.grad, dx_j), ("dgamma", gt.grad, dg_j),
                            ("dbeta", bt.grad, db_j)):
        _assert_grad_close(got.numpy(), np.asarray(want), name)


def test_layer_norm_in_fp16_matches_jax():
    # both compute in fp32 and round once to fp16: at most one step apart,
    # 2^-10 of the value
    x, g, b = _rand((8, 256), 5), _rand((256,), 6), _rand((256,), 7)
    want = jln.layer_norm(jnp.asarray(x, jnp.float16), jnp.asarray(g),
                          jnp.asarray(b), 1e-5)
    TF.reset_layer_norm_path_log()
    got = TF.layer_norm(torch.from_numpy(x).half(), 256, torch.from_numpy(g),
                        torch.from_numpy(b), 1e-5)
    assert got.dtype == F16
    assert TF.layer_norm_paths_taken() == ["reference"]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=1e-6,
                               rtol=2.0 ** -10)


def test_layer_norm_path_log_records_each_call_and_is_bounded():
    x, g, b = (torch.from_numpy(a) for a in (_rand((4, 64), 1),
                                             _rand((64,), 2), _rand((64,), 3)))
    TF.reset_layer_norm_path_log()
    TF.layer_norm(x, 64, g, b)
    TF.layer_norm(x.half(), 64, g, b)
    TF.layer_norm(x, 64)                      # no scale and bias: no route
    assert TF.layer_norm_paths_taken() == ["reference", "reference"]
    for _ in range(TF._LN_PATH_LOG.maxlen + 5):
        TF._LN_PATH_LOG.append("reference")
    assert len(TF.layer_norm_paths_taken()) == TF._LN_PATH_LOG.maxlen
    TF.reset_layer_norm_path_log()
    assert TF.layer_norm_paths_taken() == []
