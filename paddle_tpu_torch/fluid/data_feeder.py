"""``fluid.data_feeder``: ``DataFeeder`` of ``paddle_tpu/fluid/
data_feeder.py``: sample tuples to the executor's feed dict, a field of
one shape stacked, a ragged field packed into a ``LoDTensor`` and fed
padded (``LoDTensor.to_padded``), as there."""
import numpy as np

from ..core.lod import LoDTensor


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        self._names = [v if isinstance(v, str) else v.name
                       for v in feed_list]

    def feed(self, iterable):
        cols = list(zip(*iterable))
        out = {}
        for name, col in zip(self._names, cols):
            arrs = [np.asarray(v) for v in col]
            if len({a.shape for a in arrs}) == 1:
                out[name] = np.stack(arrs)
            else:
                packed = np.concatenate(
                    [a.reshape(len(a), -1) for a in arrs])
                out[name] = LoDTensor(
                    packed, [[len(a) for a in arrs]]).to_padded()[0]
        return out
