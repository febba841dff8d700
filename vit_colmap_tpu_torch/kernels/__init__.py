"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper takes its plain version for a tensor on the CPU, and launches
its kernel (or raises) for a CUDA tensor.  ``launches`` counts kernel
launches by wrapper name, so a run can show that a path went through them:
``launches.clear()`` before it, ``launches["match_topk2"]`` after.
"""

from collections import Counter

launches: Counter = Counter()
