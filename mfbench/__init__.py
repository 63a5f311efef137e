"""The benchmark of ``morefusion_tpu_torch``, the PyTorch and CUDA port, on
NVIDIA GPUs: ``python -m mfbench.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` from the root of a checkout (``mfbench/harness.py``
says how a run goes). Nothing here imports JAX or the JAX package."""
