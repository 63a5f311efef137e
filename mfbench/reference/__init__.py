"""The benchmark's plain reference: PyTorch alone, in float32.

Frozen copies of the port's model, loss, augmentation, transfer form, crop
and ICC code, with the two CUDA kernels replaced by their plain PyTorch
versions. Nothing here imports the port, JAX or the JAX package: the
benchmark hands both sides the same inputs and weights, and the reference
works out again whatever the port derives from them.
"""
