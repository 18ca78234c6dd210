"""Host-side utilities of the port: metrics, checkpoints, the CUDA probe."""
