"""MobileNetV2 and VGG 11/16/19.

Counterpart of ``paddle_tpu/models/vision_zoo.py``, with the same
parameter names: MobileNetV2's inverted residuals (ReLU6, depthwise 3x3
convolutions with groups equal to the channels) and VGG's conv stacks
with Dropout and ``AdaptiveAvgPool2D(7)``. Constructors take
``device=None``.
"""
from __future__ import annotations

from .. import nn


def _make_divisible(v, divisor=8, min_value=None):
    """The reference's channel rounding: to the nearest multiple of
    ``divisor``, never dropping more than 10%."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _ConvBNReLU(nn.Sequential):
    def __init__(self, c_in, c_out, k, stride=1, groups=1, relu6=True,
                 device=None):
        pad = (k - 1) // 2
        super().__init__(
            nn.Conv2D(c_in, c_out, k, stride=stride, padding=pad,
                      groups=groups, bias_attr=False, device=device),
            nn.BatchNorm2D(c_out, device=device),
            nn.ReLU6() if relu6 else nn.ReLU())


class InvertedResidual(nn.Layer):
    """1x1 expand, 3x3 depthwise, 1x1 project; residual when the stride is
    1 and the shapes match."""

    def __init__(self, c_in, c_out, stride, expand_ratio, device=None):
        super().__init__(device)
        hidden = int(round(c_in * expand_ratio))
        self.use_res = stride == 1 and c_in == c_out
        layers = []
        if expand_ratio != 1:
            layers.append(_ConvBNReLU(c_in, hidden, 1, device=device))
        layers += [
            _ConvBNReLU(hidden, hidden, 3, stride=stride, groups=hidden,
                        device=device),
            nn.Conv2D(hidden, c_out, 1, bias_attr=False, device=device),
            nn.BatchNorm2D(c_out, device=device),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    # (expand_ratio, c_out, n_blocks, stride)
    CFG = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]

    def __init__(self, num_classes: int = 1000, scale: float = 1.0,
                 in_channels: int = 3, device=None):
        super().__init__(device)
        c = _make_divisible(32 * scale)
        last = _make_divisible(1280 * max(1.0, scale))
        feats = [_ConvBNReLU(in_channels, c, 3, stride=2, device=device)]
        for t, co, n, s in self.CFG:
            co = _make_divisible(co * scale)
            for i in range(n):
                feats.append(InvertedResidual(c, co, s if i == 0 else 1, t,
                                              device=device))
                c = co
        feats.append(_ConvBNReLU(c, last, 1, device=device))
        self.features = nn.Sequential(*feats)
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.classifier = nn.Linear(last, num_classes, device=device)

    def forward(self, x):
        x = self.pool(self.features(x))
        return self.classifier(x.reshape([x.shape[0], -1]))


def mobilenet_v2(num_classes: int = 1000, scale: float = 1.0,
                 **kw) -> MobileNetV2:
    return MobileNetV2(num_classes=num_classes, scale=scale, **kw)


_VGG_CFGS = {
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGG(nn.Layer):
    def __init__(self, depth: int = 16, num_classes: int = 1000,
                 batch_norm: bool = False, in_channels: int = 3,
                 fc_dim: int = 4096, device=None):
        super().__init__(device)
        layers = []
        c = in_channels
        for v in _VGG_CFGS[depth]:
            if v == "M":
                layers.append(nn.MaxPool2D(2, stride=2))
                continue
            layers.append(nn.Conv2D(c, v, 3, padding=1,
                                    bias_attr=not batch_norm,
                                    device=device))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v, device=device))
            layers.append(nn.ReLU())
            c = v
        self.features = nn.Sequential(*layers)
        self.pool = nn.AdaptiveAvgPool2D(7)
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, fc_dim, device=device), nn.ReLU(),
            nn.Dropout(0.5),
            nn.Linear(fc_dim, fc_dim, device=device), nn.ReLU(),
            nn.Dropout(0.5),
            nn.Linear(fc_dim, num_classes, device=device))

    def forward(self, x):
        x = self.pool(self.features(x))
        return self.classifier(x.reshape([x.shape[0], -1]))


def vgg11(**kw) -> VGG:
    return VGG(11, **kw)


def vgg16(**kw) -> VGG:
    return VGG(16, **kw)


def vgg19(**kw) -> VGG:
    return VGG(19, **kw)
