"""Reader decorators: ``batch`` of ``paddle_tpu/reader.py`` (:391)."""
from __future__ import annotations

from typing import Callable


def batch(reader: Callable, batch_size: int, drop_last: bool = False):
    """A reader of lists of ``batch_size`` samples (the last one shorter
    unless ``drop_last``)."""
    def gen():
        b = []
        for item in reader():
            b.append(item)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return gen
