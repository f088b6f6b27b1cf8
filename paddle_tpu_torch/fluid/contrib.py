"""``fluid.contrib``: static mixed precision (``mixed_precision``)."""
from ..contrib import mixed_precision  # noqa: F401
