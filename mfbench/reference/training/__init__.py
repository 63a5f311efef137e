"""Frozen copies of the port's augmentation and transfer form."""
