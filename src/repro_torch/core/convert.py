"""Building the port's version graphs from another package's edge arrays.

A version graph crosses between packages as its flat edge arrays (numpy
``src`` / ``dst`` / ``delta`` / ``phi``, as :class:`EdgeArrays` holds them),
so both packages solve the very same instance.  Stores need no conversion:
their bytes are shared already.
"""

from __future__ import annotations

import numpy as np

from .version_graph import VersionGraph


def graph_from_arrays(
    n: int,
    directed: bool,
    src: np.ndarray,
    dst: np.ndarray,
    delta: np.ndarray,
    phi: np.ndarray,
) -> VersionGraph:
    """A :class:`VersionGraph` of ``n`` versions holding exactly the given
    edges.  No edge is mirrored: an undirected graph's edge arrays already
    hold both directions of every revealed pair."""
    g = VersionGraph(n, directed=directed)
    g.add_edges_bulk(
        np.asarray(src), np.asarray(dst), np.asarray(delta), np.asarray(phi),
        mirror=False,
    )
    return g
