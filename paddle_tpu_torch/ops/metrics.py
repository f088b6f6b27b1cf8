"""Metric ops: ``accuracy``.

Counterpart of ``paddle_tpu/ops/metrics.py`` :10: the share of rows whose
label is among the top-k predicted ids (Indices [N, k], Label [N, 1]),
with the count of correct rows (int32) and of all rows.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("accuracy", inputs=("Out", "Indices", "Label"),
             outputs=("Accuracy", "Correct", "Total"), no_grad=True)
def _accuracy(ctx, ins, attrs):
    indices, label = ins["Indices"][0], ins["Label"][0]
    if label.dim() == 2:
        label = label[:, 0]
    correct = (indices == label[:, None]).any(dim=1)
    num_correct = correct.to(torch.int32).sum(dtype=torch.int32)
    total = torch.full((), label.shape[0], dtype=torch.int32,
                       device=label.device)
    # a true division, as the JAX op's float32 / int
    return {"Accuracy": [num_correct.float() / total.float()],
            "Correct": [num_correct], "Total": [total]}
