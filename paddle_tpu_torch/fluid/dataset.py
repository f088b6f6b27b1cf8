"""``fluid.dataset``: the dataset pipeline of ``dataset/``."""
from ..dataset.dataset import (DataFeedDesc, DatasetFactory,  # noqa: F401
                               InMemoryDataset, MultiSlotDataGenerator,
                               MultiSlotDesc, QueueDataset, Slot)
