"""Hand-written CUDA C++ kernels for the H100 (``csrc/``), one wrapper each.

Every wrapper takes its plain PyTorch version for tensors on the CPU, and
launches its kernel for CUDA tensors or raises.  Each keeps a plain integer
launch counter on itself (``jacobi_sweep.launches`` …) that counts its kernel
launches and nothing else.
"""
