"""PyTorch/CUDA port of `drone2d_tpu` for NVIDIA Hopper.

A second package beside the JAX one, with the same module names.  It imports
torch, numpy and the standard library, never JAX or `drone2d_tpu`.  Entry
points run on the CUDA card unless the caller passes `device="cpu"`.
"""
