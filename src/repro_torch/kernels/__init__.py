"""Hand-written CUDA kernels of the port, their wrappers and tile plans.

Importing this package builds nothing: a kernel is compiled with nvcc
at its first launch on a CUDA tensor (:mod:`repro_torch.kernels.build`).
"""
