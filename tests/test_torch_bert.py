"""The port's BERT forward against the JAX package's, on the CPU.

A JAX BertForPretraining is built under a seed; its state_of, as numpy,
is carried into the port by load_reference_state; both run in eval mode
on the same numpy inputs. Also: the carry-across's errors, the device
rule, the CPU path log, and that the port imports neither JAX nor
paddle_tpu.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.dygraph import Tensor, seed
from paddle_tpu.jit import functional_call, state_of
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.jit import load_reference_state
from paddle_tpu_torch.jit import state_of as t_state_of
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.nn.transformer import (attention_paths_taken,
                                             reset_attention_path_log)

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)

CFG = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=256,
           max_position_embeddings=64)
B, S, M = 3, 32, 5

# fp32 on both sides, different summation orders over 2 layers: logits of
# magnitude ~1 agree to ~1e-5; the bound leaves a factor of ten
FP32_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def reference():
    seed(0)
    model = jbert.BertForPretraining(jbert.BertConfig(**CFG))
    state = {n: np.asarray(v) for n, v in state_of(model).items()}
    return model, state


@pytest.fixture(scope="module")
def port(reference):
    _, state = reference
    model = tbert.BertForPretraining(tbert.BertConfig(**CFG), device="cpu")
    load_reference_state(model, state)
    return model.eval()


def _inputs(seed_=1):
    rng = np.random.RandomState(seed_)
    ids = rng.randint(0, CFG["vocab_size"], (B, S)).astype(np.int32)
    types = rng.randint(0, 2, (B, S)).astype(np.int32)
    lens = np.array([S, S - 7, S // 2])
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.float32)
    pos = np.stack([np.sort(rng.choice(int(n), M, replace=False))
                    for n in lens]).astype(np.int32)
    return ids, types, mask, pos


def _run_jax(model, state, ids, types, mask, pos, amp=False):
    def call():
        return functional_call(
            model, state, Tensor(ids), Tensor(types),
            attention_mask=None if mask is None else Tensor(mask),
            masked_positions=None if pos is None else Tensor(pos),
            training=False)[0]
    if amp:
        with pt.amp.auto_cast(True, "bfloat16"):
            mlm, nsp = call()
    else:
        mlm, nsp = call()
    return (np.asarray(mlm.astype(np.float32)),
            np.asarray(nsp.astype(np.float32)))


def _run_port(model, ids, types, mask, pos, amp=False):
    def t(a):
        return None if a is None else torch.from_numpy(a)
    with torch.no_grad(), tamp.auto_cast(enable=amp):
        mlm, nsp = model(t(ids), t(types), attention_mask=t(mask),
                         masked_positions=t(pos))
    return mlm.float().numpy(), nsp.float().numpy()


@pytest.mark.parametrize("with_mask", [True, False])
def test_bert_forward_fp32_matches_jax(reference, port, with_mask):
    jmodel, state = reference
    ids, types, mask, pos = _inputs()
    if not with_mask:
        mask, pos = None, None
    mlm_j, nsp_j = _run_jax(jmodel, state, ids, types, mask, pos)
    mlm_t, nsp_t = _run_port(port, ids, types, mask, pos)
    assert mlm_t.shape == mlm_j.shape == (
        (B, M, CFG["vocab_size"]) if with_mask else (B, S, CFG["vocab_size"]))
    assert nsp_t.shape == nsp_j.shape == (B, 2)
    np.testing.assert_allclose(mlm_t, mlm_j, **FP32_TOL)
    np.testing.assert_allclose(nsp_t, nsp_j, **FP32_TOL)


def test_bert_forward_bf16_matches_jax(reference, port):
    # bf16 products (8 mantissa bits) rounded at different places in the two
    # packages: logits of ~1 differ by about one bf16 step (~1e-2); the
    # bound leaves a factor of three, and the argmax over the vocabulary
    # agrees at nearly every position
    jmodel, state = reference
    ids, types, mask, pos = _inputs(2)
    mlm_j, nsp_j = _run_jax(jmodel, state, ids, types, mask, pos, amp=True)
    mlm_t, nsp_t = _run_port(port, ids, types, mask, pos, amp=True)
    np.testing.assert_allclose(mlm_t, mlm_j, atol=3e-2, rtol=2e-2)
    np.testing.assert_allclose(nsp_t, nsp_j, atol=3e-2, rtol=2e-2)
    agree = (mlm_t.argmax(-1) == mlm_j.argmax(-1)).mean()
    assert agree >= 0.95, agree
    # and the bf16 path did cast: it is not the fp32 result
    mlm_f, _ = _run_port(port, ids, types, mask, pos)
    assert np.abs(mlm_t - mlm_f).max() > 1e-4


def test_sequence_classification_matches_jax(reference):
    seed(3)
    jmodel = jbert.BertForSequenceClassification(jbert.BertConfig(**CFG),
                                                 num_classes=3)
    state = {n: np.asarray(v) for n, v in state_of(jmodel).items()}
    tmodel = tbert.BertForSequenceClassification(
        tbert.BertConfig(**CFG), num_classes=3, device="cpu")
    load_reference_state(tmodel, state)
    tmodel.eval()
    ids, types, mask, _ = _inputs(4)
    out_j = functional_call(jmodel, state, Tensor(ids), Tensor(types),
                            attention_mask=Tensor(mask), training=False)[0]
    with torch.no_grad():
        out_t = tmodel(torch.from_numpy(ids), torch.from_numpy(types),
                       attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **FP32_TOL)


def test_tied_decoder_weight_is_one_tensor(reference, port):
    _, state = reference
    word = port.bert.embeddings.word_embeddings.weight
    assert port.cls.decoder_weight is word
    names = list(t_state_of(port))
    assert "bert.embeddings.word_embeddings.weight" in names
    assert "cls.decoder_weight" not in names
    np.testing.assert_array_equal(
        port.cls.decoder_weight.detach().numpy(),
        state["bert.embeddings.word_embeddings.weight"])
    # both names in the (torch) state_dict hold the one tensor
    sd = port.state_dict()
    assert sd["cls.decoder_weight"].data_ptr() == \
        sd["bert.embeddings.word_embeddings.weight"].data_ptr()


def test_port_names_and_shapes_are_the_references(reference, port):
    _, state = reference
    own = t_state_of(port)
    assert set(own) == set(state)
    for n, t in own.items():
        assert tuple(t.shape) == state[n].shape, n


@pytest.mark.parametrize("fault", ["renamed", "missing", "extra", "shape"])
def test_load_reference_state_raises_on_mismatch(reference, fault):
    _, state = reference
    bad = dict(state)
    if fault == "renamed":
        bad["bert.pooler.dense.weight_renamed"] = \
            bad.pop("bert.pooler.dense.weight")
    elif fault == "missing":
        del bad["nsp.bias"]
    elif fault == "extra":
        bad["cls.decoder_weight"] = bad[
            "bert.embeddings.word_embeddings.weight"]
    else:
        bad["nsp.weight"] = np.zeros((3, 2), np.float32)
    model = tbert.BertForPretraining(tbert.BertConfig(**CFG), device="cpu")
    before = {n: t.detach().clone() for n, t in t_state_of(model).items()}
    with pytest.raises(ValueError if fault == "shape" else KeyError):
        load_reference_state(model, bad)
    # nothing was copied
    for n, t in t_state_of(model).items():
        assert torch.equal(t, before[n]), n


def test_cpu_forward_logs_the_reference_path(port):
    ids, types, mask, pos = _inputs()
    reset_attention_path_log()
    _run_port(port, ids, types, mask, pos)
    assert attention_paths_taken() == ["reference"] * CFG["num_hidden_layers"]


def test_building_without_cuda_raises_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tbert.BertConfig(**CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbert.BertForPretraining(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbert.BertModel(cfg, device="gpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paddle_tpu_torch.set_device("gpu")
    assert paddle_tpu_torch.get_device() == "gpu"
    assert tbert.BertModel(cfg, device="cpu").embeddings.word_embeddings \
        .weight.device.type == "cpu"


def test_set_device_cpu_makes_cpu_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tdevice, "_DEVICE", "gpu")
    assert paddle_tpu_torch.set_device("cpu") == "cpu"
    model = tbert.BertModel(tbert.BertConfig(**CFG))
    assert next(model.parameters()).device.type == "cpu"
    with pytest.raises(ValueError, match="unknown device"):
        paddle_tpu_torch.set_device("tpu")


def test_port_imports_neither_jax_nor_paddle_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import paddle_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    paddle_tpu_torch.__path__, 'paddle_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith('jax.') or m == 'paddle_tpu' or\n"
        "             m.startswith('paddle_tpu.'))\n"
        "assert len(names) >= 15, names\n"
        "for n in ('paddle_tpu_torch.optimizer', 'paddle_tpu_torch.jit',\n"
        "          'paddle_tpu_torch.optimizer.lr_scheduler',\n"
        "          'paddle_tpu_torch.optimizer.static_opt',\n"
        "          'paddle_tpu_torch.amp',\n"
        "          'paddle_tpu_torch.generation',\n"
        "          'paddle_tpu_torch.generation.model',\n"
        "          'paddle_tpu_torch.generation.sampling',\n"
        "          'paddle_tpu_torch.generation.kv_cache',\n"
        "          'paddle_tpu_torch.generation.engine',\n"
        "          'paddle_tpu_torch.generation.scheduler',\n"
        "          'paddle_tpu_torch.kernels.paged_attention',\n"
        "          'paddle_tpu_torch.quant', 'paddle_tpu_torch.flags',\n"
        "          'paddle_tpu_torch.quant.convert',\n"
        "          'paddle_tpu_torch.ops.quantize',\n"
        "          'paddle_tpu_torch.monitor', 'paddle_tpu_torch.tracing',\n"
        "          'paddle_tpu_torch.serving', 'paddle_tpu_torch.io',\n"
        "          'paddle_tpu_torch.inference',\n"
        "          'paddle_tpu_torch.ops.reduce',\n"
        "          'paddle_tpu_torch.core.program',\n"
        "          'paddle_tpu_torch.core.scope',\n"
        "          'paddle_tpu_torch.core.registry',\n"
        "          'paddle_tpu_torch.core.shape_inference',\n"
        "          'paddle_tpu_torch.core.backward',\n"
        "          'paddle_tpu_torch.core.executor',\n"
        "          'paddle_tpu_torch.core.passes',\n"
        "          'paddle_tpu_torch.ops', 'paddle_tpu_torch.ops.common',\n"
        "          'paddle_tpu_torch.ops.math',\n"
        "          'paddle_tpu_torch.ops.elementwise',\n"
        "          'paddle_tpu_torch.ops.activation',\n"
        "          'paddle_tpu_torch.ops.tensor',\n"
        "          'paddle_tpu_torch.ops.random', 'paddle_tpu_torch.ops.nn',\n"
        "          'paddle_tpu_torch.ops.fused',\n"
        "          'paddle_tpu_torch.ops.optimizers',\n"
        "          'paddle_tpu_torch.layers.nn', 'paddle_tpu_torch.static',\n"
        "          'paddle_tpu_torch.models.resnet',\n"
        "          'paddle_tpu_torch.models.lenet',\n"
        "          'paddle_tpu_torch.models.vision_zoo',\n"
        "          'paddle_tpu_torch.fluid',\n"
        "          'paddle_tpu_torch.fluid.layers',\n"
        "          'paddle_tpu_torch.fluid.nets',\n"
        "          'paddle_tpu_torch.fluid.data_feeder',\n"
        "          'paddle_tpu_torch.contrib.mixed_precision',\n"
        "          'paddle_tpu_torch.ops.amp',\n"
        "          'paddle_tpu_torch.ops.metrics',\n"
        "          'paddle_tpu_torch.datasets', 'paddle_tpu_torch.reader',\n"
        "          'paddle_tpu_torch.compiler', 'paddle_tpu_torch.dataset',\n"
        "          'paddle_tpu_torch.dataset.dataset',\n"
        "          'paddle_tpu_torch.dataset.native',\n"
        "          'paddle_tpu_torch.dygraph', 'paddle_tpu_torch.tensor',\n"
        "          'paddle_tpu_torch.core.enforce',\n"
        "          'paddle_tpu_torch.ops.tensor_fns',\n"
        "          'paddle_tpu_torch.fluid.dataset',\n"
        "          'paddle_tpu_torch.fluid.data_feed_desc',\n"
        "          'paddle_tpu_torch.fluid.data_generator'):\n"
        "    assert n in names, n\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
