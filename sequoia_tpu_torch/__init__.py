"""PyTorch/CUDA port of sequoia_tpu for NVIDIA Hopper (H100).

The JAX package ``sequoia_tpu`` is the reference; this package mirrors its
layout (``models/``, ``ops/``, ``pipeline/``, ``serve.py``) and imports
nothing of it.  Each TPU (Pallas) kernel on a ported path is a CUDA C++
kernel under ``csrc/``, built with nvcc for ``sm_90a`` at first use
(``_build.py``) and held beside a plain PyTorch version of the same function.

Importing the package touches no GPU and builds nothing.
"""
