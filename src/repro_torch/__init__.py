"""PyTorch/CUDA port of the SP-Async SSSP system.

A second package beside the JAX reference (``repro``): it imports torch and
numpy only. The main path is ``core.SsspEngine`` on the single-device
``sim`` backend, whose round runs the hand-written CUDA relax, send and
merge kernels of ``kernels/`` on a GPU (their plain PyTorch versions on
CPU tensors).
"""
