"""Tensor containers beyond the dense tensor (counterpart of
``paddle_tpu/core/containers.py``): ``TensorArray``, Paddle's list of
tensors for dynamic loops (``paddle.tensor.array``), and
``SelectedRows``, the (rows, values) pair of a sparse row gradient,
which ``to_dense`` scatter-adds into its table on the values' device."""
from __future__ import annotations

import numpy as np
import torch

from .tensor import Tensor, to_tensor, wrap

__all__ = ["TensorArray", "SelectedRows",
           "create_array", "array_write", "array_read", "array_length"]


def _tensor(t):
    return t if isinstance(t, Tensor) else to_tensor(t)


def _index(i):
    return int(i.item()) if isinstance(i, torch.Tensor) else int(i)


class TensorArray:
    """An append-only list of same-rank Tensors with stack / concat
    views."""

    def __init__(self, dtype="float32"):
        self.dtype = dtype
        self._items: list[Tensor] = []

    def append(self, t):
        self._items.append(_tensor(t))
        return self

    def write(self, index, t):
        index = int(index)
        if index > len(self._items):
            # Paddle's array_write permits i <= len (the append position)
            raise IndexError(
                f"array_write index {index} > length {len(self._items)}")
        if index == len(self._items):
            self._items.append(None)
        self._items[index] = _tensor(t)
        return self

    def read(self, index):
        return self._items[int(index)]

    def __len__(self):
        return len(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def stack(self, axis=0):
        from .. import ops

        return ops.stack(self._items, axis=axis)

    def concat(self, axis=0):
        from .. import ops

        return ops.concat(self._items, axis=axis)

    def pop(self, index=-1):
        return self._items.pop(index)


class SelectedRows:
    """Sparse rows: ``rows[i]`` indexes the dense table's first dim,
    ``values[i]`` is that row's data."""

    def __init__(self, rows, values, height):
        values = values if isinstance(values, torch.Tensor) else \
            torch.as_tensor(np.asarray(values))
        self.values = torch.Tensor.view_as(values, values) \
            if isinstance(values, Tensor) else values
        self.rows = torch.as_tensor(
            rows.tolist() if isinstance(rows, torch.Tensor) else
            np.asarray(rows), dtype=torch.int64, device=self.values.device)
        self.height = int(height)

    def to_dense(self):
        """The dense table; duplicate rows add up (Paddle's
        merge_selected_rows)."""
        out = torch.zeros((self.height,) + tuple(self.values.shape[1:]),
                          dtype=self.values.dtype, device=self.values.device)
        return wrap(out.index_add(0, self.rows, self.values))

    def merge(self):
        """Duplicate rows coalesced (Paddle's merge_selected_rows op)."""
        uniq = torch.unique(self.rows)
        dense = self.to_dense()
        dense = torch.Tensor.view_as(dense, dense)
        return SelectedRows(uniq, dense[uniq], self.height)

    def __repr__(self):
        return (f"SelectedRows(height={self.height}, "
                f"nrows={self.rows.shape[0]})")


# -- paddle.tensor.array's functions -----------------------------------------
def create_array(dtype="float32", initialized_list=None):
    arr = TensorArray(dtype)
    for t in initialized_list or []:
        arr.append(t)
    return arr


def array_write(x, i, array=None):
    if array is None:
        array = TensorArray()
    array.write(_index(i), x)
    return array


def array_read(array, i):
    return array.read(_index(i))


def array_length(array):
    """The length as an int64 Tensor."""
    return to_tensor(np.asarray(len(array), np.int64))
