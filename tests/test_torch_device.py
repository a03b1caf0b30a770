"""The port's measurement timer (grayscott_tpu_torch/utils/device.py), on
the host clock: the CUDA-event branch runs only on the card, through the
scripts and chip_smoke.py."""

import time

import pytest

from grayscott_tpu_torch.utils import device


@pytest.mark.parametrize("reps,best_of", [(1, 3), (4, 1), (2, 2)])
def test_time_call_makes_a_warm_call_then_the_rounds(reps, best_of):
    calls = []
    seconds = device.time_call(lambda: calls.append(1), "cpu", reps, best_of)
    assert len(calls) == 1 + reps * best_of
    assert 0 <= seconds < 1


def test_time_call_reports_the_mean_of_a_round():
    seconds = device.time_call(lambda: time.sleep(0.01), "cpu", reps=3,
                               best_of=1)
    assert 0.009 < seconds < 0.5


def test_device_name_on_the_cpu_says_it_is_no_device_rate():
    assert "not a device rate" in device.device_name("cpu")
