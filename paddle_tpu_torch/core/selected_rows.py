"""SelectedRows: the row-sparse gradient of an embedding table.

Counterpart of ``paddle_tpu/core/selected_rows.py``: ``rows`` (int64,
[n]) index the ``height`` rows of a dense [height, ...] tensor and
``values`` ([n, ...]) hold their data; a row may repeat, and a row equal
to ``height`` is a drop marker (a ``padding_idx`` id, or a slot that a
merge vacated), which ``to_dense`` drops.

On the card a torch index op reached by the marker is a device-side
assert, which ends the CUDA context; so nothing here indexes with a row
as it is. ``to_dense`` writes into a scratch row past the last, and the
sparse update rules (``optimizer/static_opt.py``) read through
``safe_rows`` and write through ``scatter_rows``. ``merged`` keeps the
JAX contract (``selected_rows.py:62-78``): the same length as the input,
the rows sorted and unique, the vacated slots given row ``height``, and
idempotent. Its sums are bitwise repeatable on the card: a stable sort,
then ``segment_reduce``, one sequential sum per (row, feature), not the
atomics of ``index_add_``. Nothing in it reads a value back to the host.

Autograd carries a sparse embedding's gradient as a torch sparse COO
tensor (``nn/functional.py`` ``embedding(sparse=True)``): its constructor
checks its indices, so a padding id rides in it at its own row, and
``from_grad`` turns it into the marker, with the ``padding_idx`` the
embedding recorded on its weight.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["SelectedRows", "padding_of", "safe_rows", "scatter_rows"]

# the attribute of a weight on which embedding(sparse=True) records its
# padding row
PADDING_ATTR = "_sparse_padding_idx"


def padding_of(weight: torch.Tensor) -> Optional[int]:
    return getattr(weight, PADDING_ATTR, None)


class SelectedRows:
    __slots__ = ("rows", "values", "height", "_is_merged")

    def __init__(self, rows, values, height: int):
        values = values if isinstance(values, torch.Tensor) else \
            torch.from_numpy(np.array(values))
        rows = rows if isinstance(rows, torch.Tensor) else \
            torch.from_numpy(np.array(rows))
        self.rows = rows.to(device=values.device, dtype=torch.int64)
        self.values = values
        self.height = int(height)
        self._is_merged = False

    @staticmethod
    def from_grad(grad: torch.Tensor,
                  padding_idx: Optional[int] = None) -> "SelectedRows":
        """The SelectedRows of a sparse COO gradient (uncoalesced: its
        entries in the order autograd accumulated them); entries at
        ``padding_idx`` become the marker."""
        height = grad.shape[0]
        rows = grad._indices()[0]
        if padding_idx is not None:
            rows = torch.where(rows == padding_idx,
                               torch.full_like(rows, height), rows)
        return SelectedRows(rows, grad._values(), height)

    @property
    def shape(self):
        return (self.height,) + tuple(self.values.shape[1:])

    @property
    def dtype(self):
        return self.values.dtype

    def valid(self) -> torch.Tensor:
        """True where the row is a row of the table (not the marker)."""
        return self.rows < self.height

    def to_dense(self) -> torch.Tensor:
        """The dense [height, ...] tensor, the marker rows dropped. The
        rows are merged first, so each is written once (no atomics)."""
        m = self.merged()
        dense = torch.zeros((self.height + 1,) + tuple(m.values.shape[1:]),
                            dtype=m.values.dtype, device=m.values.device)
        # every marker lands in the scratch row past the last
        dense.index_copy_(0, m.rows, m.values)
        return dense[:self.height]

    def merged(self) -> "SelectedRows":
        """Duplicate rows summed; the same length, the rows sorted and
        unique, the vacated slots given row ``height`` (zeros)."""
        if self._is_merged:
            return self
        n = self.rows.shape[0]
        sorted_rows, order = torch.sort(self.rows, stable=True)
        vals = self.values.reshape(n, -1)[order]
        head = torch.ones_like(sorted_rows, dtype=torch.bool)
        head[1:] = sorted_rows[1:] != sorted_rows[:-1]
        seg = torch.cumsum(head.long(), 0) - 1
        offsets = torch.searchsorted(
            seg, torch.arange(n + 1, device=seg.device))
        summed = torch.segment_reduce(vals, "sum", offsets=offsets, axis=0,
                                      unsafe=True)
        rows = torch.full((n + 1,), self.height, dtype=torch.int64,
                          device=seg.device)
        # segment k's row at slot k; the slot past the last takes every
        # non-head entry (the same row written again by the heads)
        rows.index_copy_(0, torch.where(head, seg, torch.full_like(seg, n)),
                         sorted_rows)
        out = SelectedRows(rows[:n], summed.reshape(self.values.shape),
                           self.height)
        out._is_merged = True
        return out

    def map_values(self, fn) -> "SelectedRows":
        """fn of the values, the rows kept (and merged-ness with them)."""
        out = SelectedRows(self.rows, fn(self.values), self.height)
        out._is_merged = self._is_merged
        return out

    def __add__(self, other):
        if isinstance(other, SelectedRows):
            if other.height != self.height:
                raise ValueError(f"SelectedRows heights {self.height} and "
                                 f"{other.height} differ")
            return SelectedRows(torch.cat([self.rows, other.rows]),
                                torch.cat([self.values, other.values]),
                                self.height)
        if other is None:
            return self
        return self.to_dense() + other

    __radd__ = __add__

    def __mul__(self, scalar):
        return SelectedRows(self.rows, self.values * scalar, self.height)

    __rmul__ = __mul__

    def numpy(self) -> np.ndarray:
        return self.to_dense().detach().cpu().numpy()

    def __repr__(self):
        return (f"SelectedRows(height={self.height}, "
                f"nnz_rows={self.rows.shape[0]}, "
                f"value_shape={tuple(self.values.shape)})")


def safe_rows(sr: SelectedRows) -> torch.Tensor:
    """The rows with the marker clamped to the last row: for reads only
    (``m[min(rows, h - 1)]`` of the JAX rules)."""
    return sr.rows.clamp(max=sr.height - 1)


def scatter_rows(dst: torch.Tensor, sr: SelectedRows,
                 new: torch.Tensor) -> None:
    """dst[rows] = new in place for the rows of a merged ``sr``, the
    marker slots dropped (JAX's ``.at[rows].set(new, mode="drop")``),
    with no marker index and no write whose value depends on the order of
    the writes: each marker slot writes the row and value of the last
    real slot again (the rows are sorted, the markers last), and with no
    real slot at all, the last row's own value."""
    n = sr.rows.shape[0]
    valid = sr.valid()
    n_valid = valid.sum()
    src = torch.where(valid, torch.arange(n, device=valid.device),
                      (n_valid - 1).clamp(min=0))
    rows = sr.rows[src].clamp(max=sr.height - 1)
    vals = torch.where((n_valid > 0).reshape((1,) * new.dim()),
                       new[src], dst[rows])
    dst.index_copy_(0, rows, vals.to(dst.dtype))
