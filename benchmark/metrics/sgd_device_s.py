"""Seconds on the device's clock of the epoch replays of the traced update
(the program's span `update.sgd`): the reader of `rollout_device_s.py`."""

from benchmark.harness import BENCH, load_module

device_seconds = load_module(BENCH / "metrics" / "rollout_device_s.py").device_seconds


def read(run):
    return device_seconds(run, "update.sgd")
