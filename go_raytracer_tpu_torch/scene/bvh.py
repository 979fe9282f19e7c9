"""Host-side BVH build over triangle bounds, flattened for stackless
traversal on device.

Build policy matches the reference (hittable/bvh.go:35-61): union bbox of
the span, split on its longest axis (aabb.go:73-87), sort the sub-span by
bbox min (then max) on that axis (bvh.go:25-32), median split, recurse.
Instead of a pointer tree walked recursively per ray, the tree is emitted
in depth-first order with *skip links*: a ray that hits a node's box steps
to the next node in DFS order (its first child); a miss jumps the whole
subtree. Leaves hold fixed-size runs of reordered triangle indices so the
device loop intersects a dense (N, LEAF) block per visit.

Boxes are padded like the reference: triangle bounds get a 1e-8 epsilon on
flat axes (objects.go:336-348) and every box at least 1e-4 extent
(aabb.go:118-129).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FlatBVH:
    node_min: np.ndarray    # (M, 3) f32
    node_max: np.ndarray    # (M, 3) f32
    first: np.ndarray       # (M,) i32 — leaf: start into `order`; inner: unused
    count: np.ndarray      # (M,) i32 — leaf: #tris; inner: 0
    skip: np.ndarray       # (M,) i32 — next DFS node on miss / after subtree
    order: np.ndarray      # (T_padded,) i32 — reordered triangle ids (pad = -1)
    n_nodes: int
    leaf_size: int


def tri_bounds(v: np.ndarray) -> tuple:
    """Per-triangle padded AABBs; v is (T, 3, 3)."""
    lo = v.min(axis=1)
    hi = v.max(axis=1)
    eps = 1e-8
    flat = hi - lo < eps
    lo = np.where(flat, lo - eps, lo)
    hi = np.where(flat, hi + eps, hi)
    # padToMinimum
    small = hi - lo < 1e-4
    pad = 1e-4 / 2
    lo = np.where(small, lo - pad, lo)
    hi = np.where(small, hi + pad, hi)
    return lo, hi


def _sah_partition(span, lo, hi, centers, span_lo, span_hi,
                   leaf_size, n_bins=16):
    """Binned surface-area-heuristic split (Wald 2007): pick the
    (axis, bin boundary) minimizing NL*SA(L) + NR*SA(R). Returns
    (left, right) index arrays, or None when no split beats keeping the
    span together (degenerate extents / all centers in one bin) — the
    caller falls back to the reference's median split. The tree SHAPE is
    a traversal-performance choice only: closest-hit results are
    order-independent, so hit semantics match the reference either way."""
    best_cost = np.inf
    best = None
    n = len(span)
    c = centers[span]
    for axis in range(3):
        ext = span_hi[axis] - span_lo[axis]
        if ext <= 1e-12:
            continue
        b = np.clip(((c[:, axis] - span_lo[axis]) / ext * n_bins)
                    .astype(np.int64), 0, n_bins - 1)
        counts = np.bincount(b, minlength=n_bins)
        # per-bin AABBs (empty bins stay +inf/-inf and vanish in min/max)
        blo = np.full((n_bins, 3), np.inf)
        bhi = np.full((n_bins, 3), -np.inf)
        np.minimum.at(blo, b, lo[span])
        np.maximum.at(bhi, b, hi[span])
        # prefix/suffix sweep
        plo = np.minimum.accumulate(blo, axis=0)
        phi = np.maximum.accumulate(bhi, axis=0)
        slo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
        shi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
        nl = np.cumsum(counts)[:-1]
        nr = n - nl

        def area(lo_, hi_):
            d = np.maximum(hi_ - lo_, 0.0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        cost = nl * area(plo[:-1], phi[:-1]) + nr * area(slo[1:], shi[1:])
        cost = np.where((nl == 0) | (nr == 0), np.inf, cost)
        k = int(np.argmin(cost))
        if cost[k] < best_cost:
            best_cost = cost[k]
            best = (axis, ext, k)
    if best is None:
        return None
    axis, ext, k = best
    b = np.clip(((c[:, axis] - span_lo[axis]) / ext * n_bins)
                .astype(np.int64), 0, n_bins - 1)
    left = span[b <= k]
    right = span[b > k]
    if len(left) == 0 or len(right) == 0:
        return None
    return left, right


def build(v: np.ndarray, leaf_size: int = 8,
          policy: str = "median") -> FlatBVH:
    """Build the flat BVH for triangle vertices v (T, 3, 3).

    policy="median" (default) reproduces the reference's longest-axis
    median split (bvh.go:35-61); "sah" is the binned surface-area
    heuristic, kept because the JAX package's builder has it (both emit
    the same tables for the same policy)."""
    t_count = v.shape[0]
    lo, hi = tri_bounds(v)
    centers_min = lo  # reference sorts by bbox.Min (boxCompare)
    centers = 0.5 * (lo + hi)

    idx = np.arange(t_count)
    nodes = []  # rows: [min(3), max(3), first, count]
    order = []

    def emit(span):
        span_lo = lo[span].min(axis=0)
        span_hi = hi[span].max(axis=0)
        node_id = len(nodes)
        nodes.append([span_lo, span_hi, 0, 0, 0])  # skip filled later
        if len(span) <= leaf_size:
            start = len(order)
            order.extend(span.tolist())
            nodes[node_id][2] = start
            nodes[node_id][3] = len(span)
        else:
            halves = None
            if policy == "sah":
                halves = _sah_partition(span, lo, hi, centers,
                                        span_lo, span_hi, leaf_size)
            if halves is None:
                axis = int(np.argmax(span_hi - span_lo))
                keys = np.stack([centers_min[span, axis], hi[span, axis]],
                                axis=1)
                srt = span[np.lexsort((keys[:, 1], keys[:, 0]))]
                mid = len(srt) // 2
                halves = (srt[:mid], srt[mid:])
            emit(halves[0])
            emit(halves[1])
        return node_id

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        emit(idx)
    finally:
        sys.setrecursionlimit(old_limit)

    m = len(nodes)
    node_min = np.stack([n[0] for n in nodes]).astype(np.float32)
    node_max = np.stack([n[1] for n in nodes]).astype(np.float32)
    first = np.asarray([n[2] for n in nodes], dtype=np.int32)
    count = np.asarray([n[3] for n in nodes], dtype=np.int32)

    # skip links: next node in DFS order after this node's subtree.
    # subtree of node i spans [i, end_i); compute by a stack walk.
    skip = np.full(m, m, dtype=np.int32)
    stack = []  # (node, parent_end)
    # compute subtree extents: DFS emission means children of i are i+1..;
    # reconstruct ends: a leaf's subtree is itself; an inner node's subtree
    # ends where its second child's subtree ends. Walk backwards.
    end = np.zeros(m, dtype=np.int32)
    children = [[] for _ in range(m)]
    # recover structure: iterate DFS with a stack of open inner nodes
    open_stack = []
    remaining = np.where(count == 0, 2, 0)  # inner nodes expect 2 children
    for i in range(m):
        if open_stack:
            children[open_stack[-1]].append(i)
            remaining[open_stack[-1]] -= 1
        if count[i] == 0:
            open_stack.append(i)
        else:
            end[i] = i + 1
            while open_stack and remaining[open_stack[-1]] == 0:
                j = open_stack.pop()
                end[j] = end[children[j][1]]
    for i in range(m):
        skip[i] = end[i]

    # pad order so leaf reads of fixed width stay in range
    order = np.asarray(order + [-1] * leaf_size, dtype=np.int32)
    return FlatBVH(node_min=node_min, node_max=node_max, first=first,
                   count=count, skip=skip, order=order, n_nodes=m,
                   leaf_size=leaf_size)
