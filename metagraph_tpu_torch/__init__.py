"""metagraph_tpu_torch — the PyTorch and CUDA port of metagraph_tpu.

The same sub-packages and module names as ``metagraph_tpu`` (the JAX
reference, which stays as it is), holding tensors on an explicit
``device``. The two kernels of the construction path and the alignment
DP kernel are hand-written CUDA for Hopper (``csrc/``); the rest is
plain PyTorch. This package never imports JAX.
"""

__version__ = "0.1.0"
