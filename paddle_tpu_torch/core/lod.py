"""LoDTensor: the feedable variable-length batch container.

The port's own copy of ``paddle_tpu/core/lod.py`` (numpy only, no
torch): a packed [total_items, ...] buffer plus nested sequence lengths,
as the reference's LoD tensor (``lod_tensor.h:104``) holds it, with the
bridge to the padded form (``to_padded``, ``from_padded``). It stays on
the host: the executor takes a ``LoDTensor`` feed as its packed buffer
(``__array__``), as the JAX package's ``_as_feed`` does.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def _lengths_to_offsets(lengths: Sequence[int]) -> List[int]:
    out = [0]
    for n in lengths:
        out.append(out[-1] + int(n))
    return out


def _offsets_to_lengths(offsets: Sequence[int]) -> List[int]:
    return [int(b) - int(a) for a, b in zip(offsets[:-1], offsets[1:])]


class LoDTensor:
    """Packed data and nested sequence lengths. ``lod()`` gives offsets,
    ``recursive_sequence_lengths()`` lengths; each setter takes its
    style, as fluid.LoDTensor's do."""

    def __init__(self, data=None, recursive_seq_lens=None):
        self._data = None if data is None else np.asarray(data)
        self._rsl: List[List[int]] = []
        if recursive_seq_lens is not None:
            self.set_recursive_sequence_lengths(recursive_seq_lens)

    # -- the buffer -------------------------------------------------------
    def set(self, data, place=None):
        """``place`` is taken for the reference's signature; the executor
        places the feed."""
        self._data = np.asarray(data)

    def shape(self):
        return () if self._data is None else tuple(self._data.shape)

    def __array__(self, dtype=None, copy=None):
        arr = self._data if self._data is not None else np.empty((0,))
        return arr.astype(dtype) if dtype is not None else arr

    # -- the structure ----------------------------------------------------
    def set_lod(self, lod: Sequence[Sequence[int]]):
        self._rsl = [_offsets_to_lengths(level) for level in lod]

    def lod(self) -> List[List[int]]:
        return [_lengths_to_offsets(level) for level in self._rsl]

    def set_recursive_sequence_lengths(self, rsl: Sequence[Sequence[int]]):
        self._rsl = [[int(n) for n in level] for level in rsl]

    def recursive_sequence_lengths(self) -> List[List[int]]:
        return [list(level) for level in self._rsl]

    def has_valid_recursive_sequence_lengths(self) -> bool:
        if not self._rsl:
            return True
        # each level tiles the level below it, and the last level tiles
        # the leading dim of the data (lod_tensor.cc CheckLoD)
        expect = None
        for level in self._rsl:
            if expect is not None and len(level) != expect:
                return False
            expect = sum(level)
        return self._data is None or expect == self._data.shape[0]

    # -- the padded form --------------------------------------------------
    def to_padded(self, pad_value=0.0):
        """(padded [B, T_max, ...], int32 lengths [B]) of the finest
        level."""
        if self._data is None:
            raise ValueError("LoDTensor has no data")
        if not self._rsl:
            return self._data[None], np.asarray(
                [self._data.shape[0]], np.int32)
        lengths = self._rsl[-1]
        t_max = max(lengths) if lengths else 0
        trail = self._data.shape[1:]
        out = np.full((len(lengths), t_max) + trail, pad_value,
                      dtype=self._data.dtype)
        ofs = 0
        for i, n in enumerate(lengths):
            out[i, :n] = self._data[ofs:ofs + n]
            ofs += n
        return out, np.asarray(lengths, np.int32)

    @staticmethod
    def from_padded(padded, lengths) -> "LoDTensor":
        padded = np.asarray(padded)
        lengths = [int(n) for n in np.asarray(lengths)]
        packed = np.concatenate(
            [padded[i, :n] for i, n in enumerate(lengths)], axis=0) \
            if lengths else padded.reshape((0,) + padded.shape[2:])
        return LoDTensor(packed, [lengths])

    def __repr__(self):
        return "LoDTensor(shape=%s, recursive_sequence_lengths=%s)" % (
            self.shape(), self._rsl)


class LoDTensorArray(list):
    """fluid.LoDTensorArray: a list of LoDTensors."""
