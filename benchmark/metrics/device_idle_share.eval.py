"""The device's idle share of the traced selection call: the reader of
`device_idle_share.train.py`."""

from benchmark.harness import BENCH, load_module

read = load_module(BENCH / "metrics" / "device_idle_share.train.py").read
