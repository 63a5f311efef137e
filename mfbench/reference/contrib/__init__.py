"""A frozen copy of the port's ICC."""
