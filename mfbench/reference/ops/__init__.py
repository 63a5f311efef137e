"""Plain versions of the port's two kernels."""
