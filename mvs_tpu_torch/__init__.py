"""PyTorch/CUDA port of mvs_tpu for NVIDIA Hopper (sm_90a).

Mirrors the module layout and public names of ``mvs_tpu`` so each function
has a findable counterpart. Imports nothing of JAX or ``mvs_tpu``; the two
hand-written CUDA kernels under ``csrc/`` are compiled at first use
(``ops._build``), so importing the package needs no CUDA.
"""
