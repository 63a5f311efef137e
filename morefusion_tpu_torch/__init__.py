"""morefusion_tpu_torch: the PyTorch and CUDA port of ``morefusion_tpu``.

Runs on one NVIDIA H100. Plain tensor code is PyTorch; the JAX package's
Pallas kernels become kernels written by hand for Hopper (``csrc/``, built
with ``nvcc`` at first use and bound with ``ctypes``). Entry points run on
``device="cuda"`` unless the caller passes ``device="cpu"``.

Conventions follow the JAX package: voxel grids are channels-last
``(B, X, Y, Z, C)`` at function boundaries, quaternions are ``(w, x, y, z)``.
The package imports nothing of JAX or of ``morefusion_tpu``.
"""

__version__ = "0.1.0"
