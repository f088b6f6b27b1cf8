"""``fluid.trainer_desc`` (``paddle_tpu/fluid/trainer_desc.py``)."""
from ..distributed import TrainerDesc, TrainerFactory  # noqa: F401
