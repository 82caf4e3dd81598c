"""The trace's reduction: busy time is the union of the device's
intervals, never more than the window."""

import pytest
import torch

from azbench import trace


def test_merge_unions_overlaps():
    assert trace._merge([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]


@pytest.mark.cuda
def test_profile_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    x = torch.randn(1024, 1024, device=dev)

    def work():
        for _ in range(20):
            x.mul_(1.0001)
            torch.cuda._sleep(100000)
    t = trace.profile(work, dev)
    assert 0 < t.busy_s <= t.window_s
    assert trace.SPAN not in t.kernels
    assert t.breakdown()["device_ops"]
