"""The port's entry points run on the card unless the caller names another
device: `generate_instance` and `from_numpy_tree` default to "cuda", and a
caller that wants the CPU says so (as every port test does)."""

import inspect

import numpy as np
import pytest
import torch

from greyjack_tpu_torch.interop import from_numpy_tree
from greyjack_tpu_torch.models.vrp import generate_instance

torch.set_num_threads(1)


@pytest.mark.parametrize("fn", [generate_instance, from_numpy_tree])
def test_default_device_is_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_named_cpu_builds_on_the_cpu():
    dom = generate_instance(12, 2, 3, seed=1, time_windowed=True,
                            device="cpu")
    assert dom.distance_matrix.device.type == "cpu"
    tree = from_numpy_tree({"a": np.arange(3, dtype=np.int32),
                            "b": [np.zeros(2)], "k": 7}, device="cpu")
    assert tree["a"].device.type == "cpu" and tree["a"].dtype == torch.int32
    assert tree["b"][0].device.type == "cpu" and tree["k"] == 7


def test_default_never_builds_quietly_on_the_cpu():
    # without a card the default device raises (torch's own error); with
    # one, the instance lands on it
    if torch.cuda.is_available():
        dom = generate_instance(12, 2, 3, seed=1)
        assert dom.distance_matrix.device.type == "cuda"
        assert from_numpy_tree(np.zeros(2)).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            generate_instance(12, 2, 3, seed=1)
        with pytest.raises((AssertionError, RuntimeError)):
            from_numpy_tree(np.zeros(2))
