"""``fluid.input``: ``embedding`` and ``one_hot`` of
``paddle_tpu/fluid/input.py``, the port's ``nn.functional`` functions."""
from ..nn.functional import embedding, one_hot  # noqa: F401
