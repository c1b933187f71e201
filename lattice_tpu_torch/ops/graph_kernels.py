"""Graph constants shared by the ranking fuse (torch port).

Port of the part of `lattice_tpu/ops/graph_kernels.py` that the query
side's host paths use: the `UNREACHED` depth sentinel and the geometric
capacity buckets. The frontier kernels of that file (`pad_edges`,
`bfs_distances{,_batch}`, `degree_counts`, `nodes_on_paths`,
`bidirectional_closure`, `khop_select`, `khop_{batch_,}bounded`,
`bfs_oracle`) are ROADMAP queue 1, item 10; `csr_expand` came over with
the graph store (`index/graph_store.py`).
"""

from __future__ import annotations

import numpy as np

UNREACHED = np.int32(2**30)


def geometric_bucket(n: int, floor: int = 1024) -> int:
    """Next power-of-two capacity >= n (min `floor`). Padding to geometric
    buckets keeps the shapes of a growing graph (watch mode adds edges file
    by file) to a few sizes."""
    cap = floor
    while cap < n:
        cap *= 2
    return cap
