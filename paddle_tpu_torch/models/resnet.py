"""ResNet: BasicBlock, BottleneckBlock, ResNet and resnet18/34/50/101/152.

Counterpart of ``paddle_tpu/models/resnet.py`` (ResNet-v1.5, the stride
in the 3x3 convolution, NCHW), with the same parameter and buffer names,
so ``jit.load_reference_state`` carries the JAX package's weights and
running statistics across. Constructors take ``device=None``: without a
CUDA card they raise unless asked for ``"cpu"``.
"""
from __future__ import annotations

from .. import nn


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, in_ch: int, ch: int, stride: int = 1,
                 downsample=None, device=None):
        super().__init__(device)
        self.conv1 = nn.Conv2D(in_ch, ch, 1, bias_attr=False, device=device)
        self.bn1 = nn.BatchNorm2D(ch, device=device)
        self.conv2 = nn.Conv2D(ch, ch, 3, stride=stride, padding=1,
                               bias_attr=False, device=device)
        self.bn2 = nn.BatchNorm2D(ch, device=device)
        self.conv3 = nn.Conv2D(ch, ch * self.expansion, 1, bias_attr=False,
                               device=device)
        self.bn3 = nn.BatchNorm2D(ch * self.expansion, device=device)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, in_ch: int, ch: int, stride: int = 1,
                 downsample=None, device=None):
        super().__init__(device)
        self.conv1 = nn.Conv2D(in_ch, ch, 3, stride=stride, padding=1,
                               bias_attr=False, device=device)
        self.bn1 = nn.BatchNorm2D(ch, device=device)
        self.conv2 = nn.Conv2D(ch, ch, 3, padding=1, bias_attr=False,
                               device=device)
        self.bn2 = nn.BatchNorm2D(ch, device=device)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Layer):
    def __init__(self, block, layers, num_classes: int = 1000,
                 in_channels: int = 3, device=None):
        super().__init__(device)
        self.in_ch = 64
        self.conv1 = nn.Conv2D(in_channels, 64, 7, stride=2, padding=3,
                               bias_attr=False, device=device)
        self.bn1 = nn.BatchNorm2D(64, device=device)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, 2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], 2)
        self.layer3 = self._make_layer(block, 256, layers[2], 2)
        self.layer4 = self._make_layer(block, 512, layers[3], 2)
        self.avgpool = nn.AdaptiveAvgPool2D(1)
        self.flatten = nn.Flatten()
        self.fc = nn.Linear(512 * block.expansion, num_classes,
                            device=device)

    def _make_layer(self, block, ch, blocks, stride=1):
        dev = self._device
        downsample = None
        if stride != 1 or self.in_ch != ch * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.in_ch, ch * block.expansion, 1,
                          stride=stride, bias_attr=False, device=dev),
                nn.BatchNorm2D(ch * block.expansion, device=dev))
        layers = [block(self.in_ch, ch, stride, downsample, device=dev)]
        self.in_ch = ch * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.in_ch, ch, device=dev))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(self.flatten(self.avgpool(x)))


def resnet18(**kw):
    return ResNet(BasicBlock, [2, 2, 2, 2], **kw)


def resnet34(**kw):
    return ResNet(BasicBlock, [3, 4, 6, 3], **kw)


def resnet50(**kw):
    return ResNet(BottleneckBlock, [3, 4, 6, 3], **kw)


def resnet101(**kw):
    return ResNet(BottleneckBlock, [3, 4, 23, 3], **kw)


def resnet152(**kw):
    return ResNet(BottleneckBlock, [3, 8, 36, 3], **kw)
