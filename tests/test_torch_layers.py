"""The port's layers, functions, AMP rule, dtypes and initializers against
the JAX package's, on the CPU.

Parameters are carried from the JAX layer into the port's by name
(load_reference_state); both run in eval mode on the same numpy inputs.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu.core import dtypes as jdtypes
from paddle_tpu.dygraph import Tensor, seed
from paddle_tpu.jit import functional_call, state_of

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core import dtypes as tdtypes
from paddle_tpu_torch.jit import load_reference_state
from paddle_tpu_torch.layers import helper as thelper
from paddle_tpu_torch.nn import functional as TF

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)

# fp32 on both sides, different summation orders
F32_TOL = dict(atol=2e-5, rtol=2e-5)


def _rand(shape, s=0):
    return np.random.RandomState(s).randn(*shape).astype(np.float32)


def _carry(jlayer, tlayer):
    state = {n: np.asarray(v) for n, v in state_of(jlayer).items()}
    load_reference_state(tlayer, state)
    return state


def _jax_eval(jlayer, state, *args, **kwargs):
    out = functional_call(jlayer, state, *[Tensor(a) for a in args],
                          training=False,
                          **{k: Tensor(v) for k, v in kwargs.items()})[0]
    return np.asarray(out)


def _port_eval(tlayer, *args, **kwargs):
    tlayer.eval()
    with torch.no_grad():
        out = tlayer(*[torch.from_numpy(a) for a in args],
                     **{k: torch.from_numpy(v) for k, v in kwargs.items()})
    return out.numpy()


LAYERS = {
    "linear": (lambda: jnn.Linear(24, 40),
               lambda: tnn.Linear(24, 40, device="cpu"), (4, 7, 24)),
    "layer_norm": (lambda: jnn.LayerNorm(40, epsilon=1e-12),
                   lambda: tnn.LayerNorm(40, epsilon=1e-12, device="cpu"),
                   (4, 7, 40)),
    "layer_norm_2d": (lambda: jnn.LayerNorm([6, 8]),
                      lambda: tnn.LayerNorm([6, 8], device="cpu"),
                      (3, 6, 8)),
    "encoder_layer": (
        lambda: jnn.TransformerEncoderLayer(64, 4, 128, dropout=0.1),
        lambda: tnn.TransformerEncoderLayer(64, 4, 128, dropout=0.1,
                                            device="cpu"),
        (2, 16, 64)),
    "encoder_layer_pre_norm": (
        lambda: jnn.TransformerEncoderLayer(64, 4, 128,
                                            normalize_before=True),
        lambda: tnn.TransformerEncoderLayer(64, 4, 128,
                                            normalize_before=True,
                                            device="cpu"),
        (2, 16, 64)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    make_j, make_t, shape = LAYERS[name]
    seed(0)
    jl, tl = make_j(), make_t()
    state = _carry(jl, tl)
    x = _rand(shape, 1)
    np.testing.assert_allclose(_port_eval(tl, x), _jax_eval(jl, state, x),
                               **F32_TOL)


def test_embedding_matches_jax_with_padding_idx():
    seed(0)
    jl = jnn.Embedding(50, 16, padding_idx=3)
    tl = tnn.Embedding(50, 16, padding_idx=3, device="cpu")
    state = _carry(jl, tl)
    ids = np.random.RandomState(2).randint(0, 50, (3, 9)).astype(np.int32)
    ids[0, :3] = 3
    out_t = _port_eval(tl, ids)
    np.testing.assert_allclose(out_t, _jax_eval(jl, state, ids), **F32_TOL)
    assert np.all(out_t[0, :3] == 0.0)


@pytest.mark.parametrize("fused", [True, False])
def test_multi_head_attention_matches_jax(fused):
    seed(4)
    jl = jnn.MultiHeadAttention(64, 4)
    tl = tnn.MultiHeadAttention(64, 4, device="cpu")
    state = _carry(jl, tl)
    x = _rand((2, 12, 64), 5)
    lens = np.array([12, 5])
    m = (np.arange(12)[None, :] < lens[:, None]).astype(np.float32)
    mask = ((1.0 - m)[:, None, None, :] *
            np.finfo(np.float32).min).astype(np.float32)
    if fused:
        out_j = _jax_eval(jl, state, x, attn_mask=mask)
        out_t = _port_eval(tl, x, attn_mask=mask)
    else:
        mem = _rand((2, 12, 64), 6)
        out_j = _jax_eval(jl, state, x, mem, mem, attn_mask=mask)
        out_t = _port_eval(tl, x, mem, mem, attn_mask=mask)
    np.testing.assert_allclose(out_t, out_j, **F32_TOL)


def test_fused_and_unfused_attention_agree():
    # the fused QKV product is the same function as three projections
    thelper.seed(7)
    tl = tnn.MultiHeadAttention(64, 4, device="cpu").eval()
    x = torch.from_numpy(_rand((2, 10, 64), 8))
    with torch.no_grad():
        fused = tl(x)
        unfused = tl(x, x, x)
    torch.testing.assert_close(fused, unfused, atol=1e-5, rtol=1e-5)


def test_gelu_is_exact_erf_like_jax():
    x = _rand((1000,), 9) * 4
    np.testing.assert_allclose(
        TF.gelu(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False)),
        **F32_TOL)


def test_dropout_eval_and_train_modes():
    x = torch.ones(200, 100)
    assert TF.dropout(x, 0.3, training=False) is x
    torch.testing.assert_close(
        TF.dropout(x, 0.3, training=False, mode="downgrade_in_infer"),
        x * 0.7)
    gen = torch.Generator().manual_seed(0)
    y = TF.dropout(x, 0.3, training=True, generator=gen)
    kept = (y != 0).float().mean().item()
    # 20000 Bernoulli(0.7) draws: 5 standard deviations is 0.016
    assert abs(kept - 0.7) < 0.016
    assert torch.all((y == 0) | torch.isclose(y, torch.tensor(1 / 0.7)))
    again = TF.dropout(x, 0.3, training=True,
                       generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(y, again)
    layer = tnn.Dropout(0.5).eval()
    assert layer(x) is x


def test_auto_cast_casts_only_the_white_list():
    x = torch.from_numpy(_rand((4, 8), 10))
    w = torch.from_numpy(_rand((8, 6), 11))
    b = torch.from_numpy(_rand((6,), 12))
    assert tamp.amp_dtype() is None
    with tamp.auto_cast():
        assert tamp.amp_dtype() == torch.bfloat16
        # bf16 product + fp32 bias promotes to fp32, as in JAX
        assert TF.linear(x, w, b).dtype == torch.float32
        assert TF.linear(x, w).dtype == torch.bfloat16
        assert TF.matmul(x, w).dtype == torch.bfloat16
        y = TF.layer_norm(x, 8, torch.ones(8), torch.zeros(8))
        assert y.dtype == torch.float32
        a, c = tamp.cast_inputs("elementwise_add", x, x)
        assert a.dtype == c.dtype == torch.float32
        with tamp.auto_cast(enable=False):
            assert TF.matmul(x, w).dtype == torch.float32
    assert tamp.amp_dtype() is None
    # the white list is the JAX tape's
    from paddle_tpu.dygraph import tape
    assert set(tamp.WHITE_LIST) == set(tape._AMP_WHITE)


def test_linear_under_auto_cast_matches_jax():
    seed(13)
    jl = jnn.Linear(32, 16)
    tl = tnn.Linear(32, 16, device="cpu")
    state = _carry(jl, tl)
    x = _rand((5, 32), 14)
    with pt.amp.auto_cast(True, "bfloat16"):
        out_j = _jax_eval(jl, state, x)
    with tamp.auto_cast():
        out_t = _port_eval(tl, x)
    assert out_t.dtype == np.float32 and out_j.dtype == np.float32
    # both round the inputs to bf16 and sum in fp32: the same products
    np.testing.assert_allclose(out_t, out_j, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("spec", ["float32", "bfloat16", "fp16", "int",
                                  "long", "bool", "uint8", "float64",
                                  np.float32, np.int64])
def test_dtype_names_match_jax(spec):
    name = tdtypes.convert_dtype(spec)
    assert name == jdtypes.convert_dtype(spec)
    assert tdtypes.convert_dtype(tdtypes.to_torch_dtype(spec)) == name
    assert tdtypes.is_float(spec) == jdtypes.is_float(spec)
    assert tdtypes.is_integer(spec) == jdtypes.is_integer(spec)


def test_dtype_rejects_unknown():
    with pytest.raises(ValueError):
        tdtypes.convert_dtype("float8")
    with pytest.raises(TypeError):
        tdtypes.set_default_dtype("int32")


def test_initializer_distributions():
    gen = torch.Generator().manual_seed(0)
    w = thelper.Xavier()([300, 500], gen)
    limit = np.sqrt(6.0 / 800)
    assert w.abs().max().item() <= limit
    # uniform(-l, l) has std l / sqrt(3); 150k draws pin it to ~0.5%
    assert abs(w.std().item() / (limit / np.sqrt(3)) - 1) < 0.01
    n = thelper.Normal(0.5, 0.02)([400, 400], gen)
    assert abs(n.mean().item() - 0.5) < 1e-3
    assert abs(n.std().item() / 0.02 - 1) < 0.01
    xn = thelper.Xavier(uniform=False)([300, 500], gen)
    assert abs(xn.std().item() / np.sqrt(2.0 / 800) - 1) < 0.01
    assert torch.equal(thelper.Constant(1.5)([3], gen), torch.full((3,), 1.5))


def test_create_parameter_defaults_and_names_match_jax():
    seed(0)
    jl = jnn.TransformerEncoderLayer(32, 4, 64)
    thelper.seed(0)
    tl = tnn.TransformerEncoderLayer(32, 4, 64, device="cpu")
    assert [n for n, _ in tl.named_parameters()] == \
        [n for n, _ in jl.named_parameters()]
    for n, p in tl.named_parameters():
        if n.endswith("bias"):
            assert torch.all(p == 0), n
    assert torch.all(tl.norm1.weight == 1)
    lim = np.sqrt(6.0 / (32 + 64))
    assert tl.linear1.weight.abs().max().item() <= lim
    # the same seed gives the same parameters again
    thelper.seed(0)
    tl2 = tnn.TransformerEncoderLayer(32, 4, 64, device="cpu")
    torch.testing.assert_close(tl.linear1.weight, tl2.linear1.weight)


def test_layer_surface():
    layer = tnn.Layer(device="cpu")
    assert layer.create_parameter([3], attr=False) is None
    p = layer.create_parameter([2, 3], attr=thelper.ParamAttr(
        initializer=thelper.Constant(2.0), trainable=False))
    assert not p.requires_grad and torch.all(p == 2.0)
    layer.add_parameter("p", p)
    child = layer.add_sublayer("child", tnn.Linear(3, 2, device="cpu"))
    assert [n for n, _ in layer.named_parameters()] == \
        ["p", "child.weight", "child.bias"]
    ll = tnn.LayerList([tnn.Linear(2, 2, device="cpu")])
    ll.append(child)
    assert len(ll) == 2 and ll[1] is child and list(ll)[1] is child
    assert set(ll.state_dict()) == {"0.weight", "0.bias", "1.weight",
                                    "1.bias"}
    layer.eval()
    assert not child.training
    layer.train()
    assert child.training


def test_attention_path_log_is_bounded():
    from paddle_tpu_torch.nn import transformer as ttr
    ttr.reset_attention_path_log()
    for _ in range(ttr._PATH_LOG.maxlen + 5):
        ttr._PATH_LOG.append("reference")
    assert len(ttr.attention_paths_taken()) == ttr._PATH_LOG.maxlen
    ttr.reset_attention_path_log()
    assert ttr.attention_paths_taken() == []
