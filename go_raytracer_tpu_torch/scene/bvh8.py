"""Host-side collapse of the binary skip-link BVH into an 8-wide BVH
("BVH8") for the stack walk of ops/traverse8.py.

Why 8-wide: one node visit slab-tests eight child boxes and one leaf visit
tests eight triangles, so the walk pops an eighth as many entries as the
binary tree would and its table reads are wide and contiguous.

The collapse is the standard wide-BVH construction: start from a binary
node's two children and repeatedly replace the largest-surface-area inner
slot with its own two children until 8 slots are filled or all slots are
leaves. Binary-tree structure is recovered from the skip links (first
child of inner i is i+1; its sibling is skip[i+1]). Split policy therefore
still matches the reference (hittable/bvh.go:35-61) — the 8-ary tree is a
reshaping of the same spatial hierarchy, not a new build.

Memory layout (both tables, value for value the JAX package's, so a scene
built by either package carries across): an entry is 8 slots of 16 float32
fields. Line-packed tables put EIGHT ENTRIES PER LINE GROUP: entry m, slot
s, field f lives at row (m >> 3) * 8 + s, column (m & 7) * 16 + f of a
(rows, 128) array, so one slot's 16 fields are 64 contiguous bytes. Padded
node tables hold one entry per 8 rows: row m * 8 + s, column f.
`entry_offsets` gives the flat offsets of both.

Node entry (per child slot s): fields 0-2 box min, 3-5 box max (NaN for
empty slots, which can never be hit), field 7 valid flag. The per-child
PUSH VALUES (inner child: its node8 id; leaf child:
-(2*first_group + (n_groups-1)) - 1) all live in SLOT 0, fields 8..15.
Triangle group entry (per triangle s): fields 0-2 v0, 3-5 e0, 6-8 e1, 9
original triangle id (leaf-order index into the scene's triangle table;
-1 padding rows are all-zero => det 0 => no hit).
"""

from __future__ import annotations

import dataclasses

import numpy as np

ROW_PAD = 16
ENTRIES_PER_LINE = 8
WIDE = 8


@dataclasses.dataclass
class BVH8:
    node_lines: np.ndarray   # (M*8, 128) padded / (ceil(M/8)*8, 128) dense
    tri_lines: np.ndarray    # (ceil(G/8)*8, 128) f32
    n_nodes: int             # M (node8 count)
    n_groups: int            # G (8-triangle groups)
    dense_nodes: bool = False  # True: nodes line-packed (roll on load)


def _pack_lines(entries: np.ndarray) -> np.ndarray:
    """(M, 8, 16) entries -> (ceil(M/8)*8, 128) lines: entry index in the
    column-block dimension, slot index in the row dimension."""
    m = entries.shape[0]
    pad = (-m) % ENTRIES_PER_LINE
    if pad:
        entries = np.concatenate(
            [entries, np.zeros((pad, WIDE, ROW_PAD), entries.dtype)])
    # (L, k=entry-in-line, s=slot, f) -> (L, s, k, f) -> (L*8, 128)
    e = entries.reshape(-1, ENTRIES_PER_LINE, WIDE, ROW_PAD)
    return np.ascontiguousarray(e.transpose(0, 2, 1, 3)).reshape(
        -1, ENTRIES_PER_LINE * ROW_PAD)


def _pad_lines(entries: np.ndarray) -> np.ndarray:
    """(M, 8, 16) entries -> (M*8, 128) lines, ONE entry per 8 rows
    (fields at columns [0, 16), rest zero): 8x the memory of _pack_lines,
    kept for small node tables because it is the JAX package's layout."""
    m, w, f = entries.shape
    out = np.zeros((m * w, ENTRIES_PER_LINE * ROW_PAD), entries.dtype)
    out[:, :f] = entries.reshape(m * w, f)
    return out


DENSE_NODE_BYTES = 24 * 1024 * 1024  # padded-node budget before packing


def collapse(node_min, node_max, first, count, skip, v0, e0, e1,
             max_leaf: int = 16, dense_nodes=None) -> BVH8:
    """Collapse a flat binary skip-link BVH (arrays as in scene/bvh.FlatBVH,
    numpy) into packed BVH8 tables. v0/e0/e1 are the (T, 3) triangle rows
    in the SAME leaf order the binary tree's first/count index into.

    Node-entry encoding: per-child push values at slot 0, fields 8..15."""
    node_min = np.asarray(node_min, np.float32)
    node_max = np.asarray(node_max, np.float32)
    first = np.asarray(first)
    count = np.asarray(count)
    skip = np.asarray(skip)
    if max_leaf > 2 * WIDE or np.any(count > 2 * WIDE):
        raise ValueError("BVH8 leaf encoding holds at most 16 triangles "
                         "(2 groups) per leaf")
    if np.any(count > max_leaf):
        raise ValueError(f"leaf count exceeds {max_leaf}")

    ext = np.maximum(node_max - node_min, 0.0)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] \
        + ext[:, 2] * ext[:, 0]

    def children(i):
        return i + 1, int(skip[i + 1])

    # BFS over binary subtree roots; each gets one node8
    slot_lists = [None]
    node8_of = {0: 0}
    pending = [0]
    qi = 0
    while qi < len(pending):
        root = pending[qi]
        my = node8_of[root]
        qi += 1
        if count[root] > 0:
            slots = [root]           # degenerate single-leaf tree
        else:
            slots = list(children(root))
            while len(slots) < WIDE:
                inner = [s for s in slots if count[s] == 0]
                if not inner:
                    break
                s = max(inner, key=lambda x: area[x])
                slots.remove(s)
                slots.extend(children(s))
        for s in slots:
            if count[s] == 0 and s not in node8_of:
                node8_of[s] = len(slot_lists)
                slot_lists.append(None)
                pending.append(s)
        slot_lists[my] = slots

    # emit node entries + leaf triangle groups
    m8 = len(slot_lists)
    nodes = np.full((m8, WIDE, ROW_PAD), np.nan, np.float32)
    nodes[:, :, 6:] = 0.0
    groups = []                       # each: (8,) int32 tri ids, -1 pad
    for my, slots in enumerate(slot_lists):
        for si, s in enumerate(slots):
            nodes[my, si, 0:3] = node_min[s]
            nodes[my, si, 3:6] = node_max[s]
            nodes[my, si, 7] = 1.0
            if count[s] == 0:
                push = node8_of[s]
            else:
                f, c = int(first[s]), int(count[s])
                g0 = len(groups)
                ng = (c + WIDE - 1) // WIDE
                for gi in range(ng):
                    ids = np.full(WIDE, -1, np.int32)
                    take = min(WIDE, c - gi * WIDE)
                    ids[:take] = np.arange(f + gi * WIDE,
                                           f + gi * WIDE + take)
                    groups.append(ids)
                push = -(2 * g0 + (ng - 1)) - 1
            nodes[my, 0, 8 + si] = float(push)

    g = len(groups)
    gids = np.stack(groups) if g else np.full((1, WIDE), -1, np.int32)
    g = gids.shape[0]
    valid = gids >= 0
    safe = np.where(valid, gids, 0)
    tri = np.zeros((g, WIDE, ROW_PAD), np.float32)
    tri[:, :, 0:3] = np.where(valid[..., None], np.asarray(v0)[safe], 0.0)
    tri[:, :, 3:6] = np.where(valid[..., None], np.asarray(e0)[safe], 0.0)
    tri[:, :, 6:9] = np.where(valid[..., None], np.asarray(e1)[safe], 0.0)
    tri[:, :, 9] = np.where(valid, gids, -1).astype(np.float32)

    # one-per-line nodes up to the budget, line-packed nodes past it
    # (the JAX package's rule, so both packages emit the same table)
    if dense_nodes is None:
        dense_nodes = m8 * WIDE * 128 * 4 > DENSE_NODE_BYTES
    pack_nodes = _pack_lines if dense_nodes else _pad_lines
    return BVH8(node_lines=pack_nodes(nodes), tri_lines=_pack_lines(tri),
                n_nodes=m8, n_groups=g, dense_nodes=dense_nodes)


def entry_offsets(m, dense: bool):
    """Flat float offset of slot 0, field 0 of entry `m` (an integer array
    or tensor) in a line-packed (`dense`) or padded table; slot s, field f
    is `+ s * 128 + f`."""
    if dense:
        return ((m >> 3) * 8) * 128 + (m & 7) * ROW_PAD
    return m * (WIDE * 128)


def max_stack(node_lines: np.ndarray, dense: bool) -> int:
    """The deepest stack the walk of ops/traverse8.py can reach on this
    node table: a visit pops one entry and pushes at most its children,
    so the bound is the largest sum, over a root-to-node path, of
    (children - 1), plus one."""
    flat = np.asarray(node_lines, np.float32).reshape(-1)
    best = 1
    todo = [(0, 1)]
    while todo:
        m, depth = todo.pop()
        off = int(entry_offsets(np.int64(m), dense))
        kids = [int(flat[off + 8 + c]) for c in range(WIDE)
                if flat[off + c * 128 + 7] > 0.0]
        depth = depth - 1 + len(kids)
        best = max(best, depth)
        todo.extend((k, depth) for k in kids if k >= 0)
    return best
