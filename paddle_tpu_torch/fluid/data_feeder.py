"""``fluid.data_feeder``: ``DataFeeder`` of ``paddle_tpu/fluid/
data_feeder.py``, for samples whose fields have one shape each (ragged
fields become LoDTensors there, which the port lacks: ``ROADMAP.md`` A2b
item 5)."""
import numpy as np


class DataFeeder:
    """Sample tuples -> the feed dict, one stacked array a field."""

    def __init__(self, feed_list, place=None, program=None):
        self._names = [v if isinstance(v, str) else v.name
                       for v in feed_list]

    def feed(self, iterable):
        cols = list(zip(*iterable))
        out = {}
        for name, col in zip(self._names, cols):
            arrs = [np.asarray(v) for v in col]
            if len({a.shape for a in arrs}) != 1:
                raise NotImplementedError(
                    f"DataFeeder: field {name!r} has samples of several "
                    "shapes; ragged fields (LoDTensor) are not ported yet "
                    "(ROADMAP.md A2b)")
            out[name] = np.stack(arrs)
        return out
