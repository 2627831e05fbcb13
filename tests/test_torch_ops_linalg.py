"""The port's manipulation, linalg and search ops against the JAX
package's: the cases, tolerances and exclusions of
``tests/test_torch_ops.py`` (which holds the other op modules; split so
each file runs in about a minute)."""
import pytest
import torch

import paddle_tpu_torch as T
from paddle_tpu_torch.core import device as tdevice
from tests.test_torch_ops import _names, check_op

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = tdevice._state["device"]
    T.set_device("cpu")
    yield
    tdevice._state["device"] = prev


@pytest.mark.parametrize("name", _names(("manipulation", "linalg",
                                         "search")))
def test_op_matches_reference(name):
    check_op(name)
