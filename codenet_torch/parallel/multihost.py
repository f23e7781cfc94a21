"""Per-process rows of each global batch (the JAX package's
parallel/multihost.py).

Every rank of a data-parallel group builds the same global batches (the
same shuffle, the same per-batch random streams: data/loader.py) and
keeps rows [lo, hi) of each. The JAX package assembles a sharded array
from those rows (`global_batch_from_local`); here each rank simply feeds
its rows to its own replica, and the collectives of parallel/mesh.py
make the step the global one.
"""

from __future__ import annotations


def process_batch_slice(global_batch_size, rank, world):
    """[lo, hi) rows of the global batch that `rank` of `world` loads: the
    JAX rule, contiguous equal shares. A batch that does not divide
    raises."""
    if global_batch_size % world:
        raise ValueError("global batch {} does not divide over {} ranks"
                         .format(global_batch_size, world))
    per = global_batch_size // world
    return rank * per, (rank + 1) * per
