"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper takes its plain version for a tensor on the CPU, and launches
its kernel (or raises) for a CUDA tensor.  ``launches`` counts kernel
launches by wrapper name, so a run can show that a path went through them:
``launches.clear()`` before it, ``launches["match_topk2"]`` after.  Every
launch goes through ``build.launch``, which adds to it through
:func:`count_launch`; mesh slots launch from several threads at once.
"""

import threading
from collections import Counter

launches: Counter = Counter()
_launches_lock = threading.Lock()


def count_launch(name: str) -> None:
    """One launch of ``name``'s kernel (thread-safe)."""
    with _launches_lock:
        launches[name] += 1
