"""``fluid.lod_tensor``: ``create_lod_tensor`` and
``create_random_int_lodtensor`` of ``paddle_tpu/fluid/lod_tensor.py``.
The random one draws from numpy's global generator, as there."""
import numpy as np

from ..core.lod import LoDTensor


def create_lod_tensor(data, recursive_seq_lens, place=None):
    return LoDTensor(np.asarray(data), recursive_seq_lens)


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place,
                                low, high):
    total = sum(recursive_seq_lens[-1])
    data = np.random.randint(low, high + 1, [total] + list(base_shape))
    return LoDTensor(data, recursive_seq_lens)
