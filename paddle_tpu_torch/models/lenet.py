"""LeNet-5 for MNIST (BASELINE config 1's model), the dygraph form.

Counterpart of ``paddle_tpu/models/lenet.py``, with the same parameter
names. The fluid book example of the same network belongs to the static
path (``ROADMAP.md`` A2b).
"""
from __future__ import annotations

from .. import nn


class LeNet(nn.Layer):
    def __init__(self, num_classes: int = 10, device=None):
        super().__init__(device)
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 5, padding=2, device=device), nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, device=device), nn.ReLU(),
            nn.MaxPool2D(2, 2))
        self.fc = nn.Sequential(
            nn.Flatten(),
            nn.Linear(16 * 5 * 5, 120, device=device), nn.ReLU(),
            nn.Linear(120, 84, device=device), nn.ReLU(),
            nn.Linear(84, num_classes, device=device))

    def forward(self, x):
        return self.fc(self.features(x))
