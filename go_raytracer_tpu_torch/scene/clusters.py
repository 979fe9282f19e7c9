"""Host-side cluster partition of the triangle BVH for the BINNED mesh
intersector (ops/stream.py + ops/trace.binned_closest).

Why: rays are SORTED BY their next candidate cluster every traversal
round, so neighbouring rays want the SAME compact triangle range and the
stream kernel tests that range densely — no stack and no per-ray tree
walk.

The partition: walk the binary BVH (scene/bvh.py — reference split
policy, bvh.go:35-61) top-down and cut every maximal subtree with
<= max_tris triangles. DFS leaf emission makes each subtree's triangles
a CONTIGUOUS run of the leaf order, so a cluster is (AABB, contiguous
8-triangle group range) and a sorted block's work is one contiguous
group interval — blocks spanning a cluster boundary just stream both
(closest-hit updates are idempotent, extra tests are waste not error).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from go_raytracer_tpu_torch.scene.bvh import FlatBVH
from go_raytracer_tpu_torch.scene.bvh8 import ROW_PAD, WIDE, _pack_lines


def pack_cluster_boxes(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Pack cluster AABBs in the bvh8._pack_lines layout: octet m holds
    clusters [8m, 8m+8) in its slots with fields lo.xyz, hi.xyz at 0-5,
    as the JAX package's in-kernel candidate scans read them. Padding
    clusters get inverted boxes (lo=+inf, hi=-inf); the port's kernels
    read only the real boxes (ops/stream2.boxes_lo_hi), since a min/max
    slab test reads an inverted box as one holding everything."""
    k = lo.shape[0]
    pad = (-k) % 8
    if pad:
        lo = np.concatenate([lo, np.full((pad, 3), np.inf, lo.dtype)])
        hi = np.concatenate([hi, np.full((pad, 3), -np.inf, hi.dtype)])
    m = lo.shape[0] // 8
    entries = np.zeros((m, 8, ROW_PAD), np.float32)
    entries[:, :, 0:3] = lo.reshape(m, 8, 3)
    entries[:, :, 3:6] = hi.reshape(m, 8, 3)
    return _pack_lines(entries)


@dataclasses.dataclass
class Clusters:
    aabb_lo: np.ndarray     # (K, 3) f32 cluster box min
    aabb_hi: np.ndarray     # (K, 3) f32 cluster box max
    group_start: np.ndarray  # (K + 1,) i32 — cluster k owns groups
    #                          [group_start[k], group_start[k+1])
    tri_lines: np.ndarray   # packed (8-tri group) lines, the
    #                          bvh8._pack_lines layout: fields 0-2 v0,
    #                          3-5 e0, 6-8 e1, 9 original tri id
    n_clusters: int
    n_groups: int


def partition(fb: FlatBVH, v0: np.ndarray, e0: np.ndarray, e1: np.ndarray,
              max_tris: int = 256, max_clusters: int = 256) -> Clusters:
    """Cut the flat BVH into clusters of <= max_tris triangles, growing
    max_tris as needed so K <= max_clusters (the binned intersector
    carries one processed-bit per cluster in K/32 int32 planes, so
    K is capped to keep the per-round sort narrow).

    v0/e0/e1 are (T, 3) triangle rows in LEAF ORDER (the same permuted
    table the BVH8 collapse uses); the emitted group table re-packs them
    per cluster (8-aligned, zero padding) so every cluster's groups are
    contiguous and dense."""
    while True:
        cl = _partition_once(fb, v0, e0, e1, max_tris)
        if cl.n_clusters <= max_clusters:
            return cl
        max_tris *= 2


def _partition_once(fb: FlatBVH, v0, e0, e1, max_tris: int) -> Clusters:
    count = fb.count
    skip = fb.skip

    # node i's subtree spans nodes [i, skip[i]); the prefix sum of leaf
    # counts in DFS node order turns that into leaf-order tri ranges
    leaf_pref = np.concatenate([[0], np.cumsum(count)])

    def subtree_tris(i):
        return int(leaf_pref[skip[i]] - leaf_pref[i])

    # leaf-order triangle start of node i's subtree = tris of nodes < i
    def subtree_first(i):
        return int(leaf_pref[i])

    clusters = []          # (lo, hi, tri_start, tri_count)
    stack = [0]
    while stack:
        i = stack.pop()
        n = subtree_tris(i)
        if n == 0:
            continue
        if n <= max_tris or count[i] > 0:
            clusters.append((fb.node_min[i], fb.node_max[i],
                             subtree_first(i), n))
        else:
            left = i + 1
            right = int(skip[left])
            # keep leaf order: left cluster ranges precede right
            stack.append(right)
            stack.append(left)
    # stack pops left first => clusters appended left-to-right, ranges
    # ascending & disjoint, covering [0, T)
    starts = [c[2] for c in clusters]
    assert starts == sorted(starts)

    entries = []
    group_start = [0]
    lo_l, hi_l = [], []
    for lo, hi, t0, tc in clusters:
        ng = (tc + WIDE - 1) // WIDE
        for g in range(ng):
            e = np.zeros((WIDE, ROW_PAD), np.float32)
            take = min(WIDE, tc - g * WIDE)
            rows = np.arange(t0 + g * WIDE, t0 + g * WIDE + take)
            e[:take, 0:3] = v0[rows]
            e[:take, 3:6] = e0[rows]
            e[:take, 6:9] = e1[rows]
            e[:take, 9] = rows.astype(np.float32)
            e[take:, 9] = -1.0
            entries.append(e)
        group_start.append(group_start[-1] + ng)
        lo_l.append(lo)
        hi_l.append(hi)

    k = len(clusters)
    g = len(entries)
    ent = (np.stack(entries) if g
           else np.zeros((1, WIDE, ROW_PAD), np.float32))
    return Clusters(
        aabb_lo=np.stack(lo_l).astype(np.float32) if k else np.zeros((1, 3), np.float32),
        aabb_hi=np.stack(hi_l).astype(np.float32) if k else np.zeros((1, 3), np.float32),
        group_start=np.asarray(group_start, dtype=np.int32),
        tri_lines=_pack_lines(ent),
        n_clusters=max(k, 1),
        n_groups=max(g, 1),
    )
