"""omchat_torch — the PyTorch / CUDA port of omchat_tpu for NVIDIA Hopper.

The JAX package (``omchat_tpu``) is the reference; this package imports
nothing of it and nothing of JAX.  Hand-written CUDA kernels live in
``omchat_torch/csrc`` and are built at first use (``ops/kernel_lib.py``).
"""
