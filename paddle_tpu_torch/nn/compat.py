"""``nn``'s cross-rank batch norm.

Counterpart of ``SyncBatchNorm`` in ``paddle_tpu/nn/compat.py`` (:368),
the only name of that file ported yet; its other names raise
``NotPortedError`` naming ``ROADMAP.md`` A8. ``SyncBatchNorm`` is
``BatchNorm2D``: where the batch is sharded over the data axis
(``TrainStep`` over a mesh, ``DataParallel``, the executor under
``with_data_parallel``), the training statistics of ``F.batch_norm`` are
already the whole batch's, reduced over the group
(``parallel.env.sharded_batch``), as the JAX package's are under GSPMD.
``convert_sync_batchnorm`` returns the layer it is given.
"""
from __future__ import annotations

from .layers_lib import BatchNorm2D

__all__ = ["SyncBatchNorm"]


class SyncBatchNorm(BatchNorm2D):
    """Batch norm over the whole sharded batch (``BatchNorm2D``'s
    statistics reduce over the data axis's group wherever the batch is
    sharded)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        return layer


# the other public names of the JAX package's nn/compat.py
_A8_NAMES = (
    "AdaptiveAvgPool1d", "AdaptiveAvgPool2d", "AdaptiveAvgPool3d",
    "AdaptiveMaxPool1d", "AdaptiveMaxPool2d", "AdaptiveMaxPool3d",
    "AlphaDropout", "AvgPool1d", "AvgPool2d", "AvgPool3d",
    "BatchNorm1d", "BatchNorm2d", "BatchNorm3d", "Bilinear",
    "BilinearTensorProduct", "CTCLoss", "ConstantPad1d", "ConstantPad2d",
    "ConstantPad3d", "Conv1d", "Conv2d", "Conv3d", "ConvTranspose1d",
    "ConvTranspose2d", "ConvTranspose3d", "CosineSimilarity", "Dropout2d",
    "Dropout3d", "ELU", "HSigmoid", "Hardshrink", "Hardtanh",
    "InstanceNorm", "InstanceNorm1d", "InstanceNorm2d", "InstanceNorm3d",
    "LogSigmoid", "LogSoftmax", "MarginRankingLoss", "MaxPool1d",
    "MaxPool2d", "MaxPool3d", "PReLU", "Pad2D", "PairwiseDistance",
    "PixelShuffle", "Pool2D", "ReflectionPad1d", "ReflectionPad2d",
    "ReplicationPad1d", "ReplicationPad2d", "ReplicationPad3d", "RowConv",
    "SELU", "Softshrink", "Softsign", "SpectralNorm", "Tanhshrink",
    "Upsample", "UpsamplingBilinear2d", "UpsamplingNearest2d",
    "ZeroPad2d", "remove_weight_norm", "weight_norm")


def __getattr__(name):
    if name in _A8_NAMES:
        from ..fluid._not_ported import not_ported
        raise not_ported(__name__, name, "A8")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
