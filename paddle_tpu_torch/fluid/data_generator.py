"""``fluid.incubate.data_generator``: ``MultiSlotDataGenerator`` of
``dataset/dataset.py``, which writes the MultiSlot text the datasets
read."""
from ..dataset.dataset import MultiSlotDataGenerator  # noqa: F401
