"""The drone environment over batch-first tensors."""
