"""``paddle.dataset``: the dataset pipeline and the reader corpora.

Counterpart of ``paddle_tpu/dataset/__init__.py``: the MultiSlot
pipeline (``DatasetFactory``, ``InMemoryDataset``, ``QueueDataset``,
``MultiSlotDesc``, ``DataFeedDesc``, ``parse_multislot``,
``using_native``) and the reader corpora that the port has
(``datasets.py``: ``mnist``). The other corpora, ``image`` and ``common``
raise naming ``ROADMAP.md`` A8.
"""
from ..datasets import mnist  # noqa: F401
from .dataset import (DataFeedDesc, DatasetFactory,  # noqa: F401
                      InMemoryDataset, MultiSlotDataGenerator, MultiSlotDesc,
                      QueueDataset, Slot)
from .native import parse_multislot, using_native  # noqa: F401

_A8 = ("cifar", "conll05", "flowers", "imdb", "imikolov", "movielens",
       "mq2007", "sentiment", "uci_housing", "voc2012", "wmt14", "wmt16",
       "image", "common")


def __getattr__(name):
    if name in _A8:
        from ..fluid._not_ported import not_ported
        raise not_ported(__name__, name, "A8")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
