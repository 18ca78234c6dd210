"""Evaluation campaigns: the 12-scenario suite, run as one env batch."""
