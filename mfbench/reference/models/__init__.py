"""Frozen copies of the port's models (see ``mfbench/reference``)."""
