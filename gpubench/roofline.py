"""Least bytes of the port's kernels, from counts the program reports, for
the benchmark's roofline shares (a kernel's least bytes over the device's
peak bandwidth, over its traced time). A count here is one that every exact
implementation must move, from counts of real data (valid arcs, branching
arcs), never from a capacity (the arc table's A, the padded H): so a share
cannot pass 100% but by a time that leaves out part of the work."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, HBM3


def branch_bytes(valid_arcs: float, branching_arcs: float) -> float:
    """Bytes the branch block moves at least over its launches, given the
    valid and the branching arcs they took: each valid arc's key (vw, 8
    bytes) and s1 (4) read and its class (1) and n_grp (4) written; each
    branching arc's target gene (8) read. The representative planes, which
    the locality test reads, are left out (how many of them a table needs
    depends on its targets), so this is a lower bound."""
    return 17.0 * valid_arcs + 8.0 * branching_arcs
