"""The fused policy kernel's share of its roofline in the traced selection
call: the reader of `policy_kernel_roofline.train.py`."""

from benchmark.harness import BENCH, load_module

read = load_module(BENCH / "metrics" / "policy_kernel_roofline.train.py").read
