"""`closest_hit_roofline`: the walk's least time over the device time of
its kernels in the traced images, in %. One query a level (a K5 launch);
its bound is bytes: the mesh's triangles read once and each queried ray
(a segment) in and out (`benchmark/roofline.py`); operations depend on
the data and are not counted.

The route's time: its own kernels (K5 and the sort's, the `closest_hit`
table), and of PyTorch's own kernels (the `tensor_ops` table) those that
the mesh level's CUDA graph launched: the walk's key, its gathers and
the scatter back. Tensor kernels outside the graph (a render's set-up,
the image's assembly) are other layers' work and are left out, and so
are the key and gathers of each window's first level, which runs before
the capture; that leaves about a hundredth of the levels' tensor time
out. Where the trace shows no K5 launch by a graph's replay (no graph,
or a trace that links no kernel to its launch), the reader cannot tell
the route's tensor kernels from the rest and returns nothing."""

from benchmark import roofline

K5 = r"\bbvh8_closest_kernel\b"


def read(run):
    t = run.trace
    queries = t.kernel_count(K5) if t else 0
    if not queries or not t.kernel_count(K5, graph=True):
        return None
    mesh = run.config["mesh"]
    n_tri = 2 * mesh["major_segments"] * mesh["minor_segments"]
    rays = sum(u["segments"] for u in run.traced_units)
    bound = roofline.closest_hit_bound_seconds(queries, n_tri, rays)
    return roofline.share_percent(
        bound, t.layer_s["closest_hit"] + t.graph_layer_s["tensor_ops"])
