"""Batched tensor ops: transforms, physics, geometry, path, the fused policy kernel."""
