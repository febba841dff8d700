"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper takes its plain version for a tensor on the CPU, and launches
its kernel (or raises) for a CUDA tensor.  ``launches`` in each module counts
kernel launches, so a run can show that its main path went through them.
"""
