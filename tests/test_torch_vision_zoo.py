"""The port's LeNet, MobileNetV2 and VGG against the JAX package's, on the
CPU: eval forwards from one state (running statistics drawn from numpy),
with the helpers of tests/test_torch_vision_models.py; and the vision
models' device rule.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.models import lenet as jlenet
from paddle_tpu.models import vision_zoo as jzoo

from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import lenet as tlenet
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.models import vision_zoo as tzoo

from test_torch_vision_models import _assert_out_close, _eval_both, _pair

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)


def test_lenet_forward_matches_jax():
    jmodel, state, port = _pair(jlenet.LeNet, tlenet.LeNet)
    assert sorted(state) == sorted(n for n, _ in port.named_parameters())
    x = np.random.RandomState(1).randn(3, 1, 28, 28).astype(np.float32)
    _assert_out_close(*_eval_both(jmodel, state, port, x))


def test_mobilenet_v2_forward_matches_jax():
    """scale 0.25: ReLU6 and depthwise convolutions (groups = channels)."""
    jmodel, state, port = _pair(
        lambda: jzoo.mobilenet_v2(num_classes=10, scale=0.25),
        lambda device: tzoo.mobilenet_v2(num_classes=10, scale=0.25,
                                         device=device))
    assert any(getattr(m, "_groups", 1) > 1 for m in port.modules())
    x = np.random.RandomState(2).randn(2, 3, 32, 32).astype(np.float32)
    _assert_out_close(*_eval_both(jmodel, state, port, x))


def test_vgg11_eval_forward_matches_jax():
    """With batch norm, at 32 x 32: the 1 x 1 features go through
    AdaptiveAvgPool2D(7)'s non-divisible (upsampling) bins; Dropout is the
    identity in eval."""
    jmodel, state, port = _pair(
        lambda: jzoo.vgg11(num_classes=7, fc_dim=64, batch_norm=True),
        lambda device: tzoo.vgg11(num_classes=7, fc_dim=64,
                                  batch_norm=True, device=device))
    x = np.random.RandomState(3).randn(2, 3, 32, 32).astype(np.float32)
    _assert_out_close(*_eval_both(jmodel, state, port, x))


@pytest.mark.parametrize("build", [
    lambda **kw: tres.resnet50(**kw), lambda **kw: tlenet.LeNet(**kw),
    lambda **kw: tzoo.mobilenet_v2(scale=0.25, **kw),
    lambda **kw: tnn.BatchNorm2D(4, **kw), lambda **kw: tnn.Conv2D(3, 4, 3,
                                                                    **kw)])
def test_vision_models_default_to_the_card(monkeypatch, build):
    """Without a CUDA card a model built with no device raises, and one
    asked for the CPU holds its parameters and running statistics there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tdevice, "_DEVICE", "gpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
    model = build(device="cpu")
    assert {t.device.type for t in model.state_dict().values()} == {"cpu"}
