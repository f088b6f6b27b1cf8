"""``fluid.data_feed_desc``: ``DataFeedDesc`` of ``dataset/dataset.py``."""
from ..dataset.dataset import DataFeedDesc  # noqa: F401
