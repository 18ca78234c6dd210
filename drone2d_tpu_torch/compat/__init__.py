"""Bridges to the JAX package's agents and state, through numpy."""
