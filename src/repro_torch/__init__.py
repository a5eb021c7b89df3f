"""PyTorch/CUDA port of the KV-reuse serving system (``repro`` is the JAX
reference it is checked against).

The port imports ``torch``, ``numpy`` and the standard library only.  Its
kernels are hand-written CUDA for Hopper (``kernels/csrc``), built
with ``nvcc`` at first use; on CPU tensors the same entry points run the
kernels' plain PyTorch versions.
"""
