"""The yardstick's bound arithmetic: the published peaks of one NVIDIA H100
(SXM, dense, at its 700 W limit) and each counted kernel's bytes and
operations, computed from the run's own counts. A kernel's least time is
the larger of its bytes over the memory bandwidth and its operations over
the float32 rate; its roofline share is that least time over the device
time it took. Each input byte is counted read once and each output byte
written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# K1 (`bounce_fused_q`): 72 B a lane (the lane state read and written),
# 16 B a lane and level (the V/FL record planes)
K1_LANE_BYTES = 72
K1_LANE_LEVEL_BYTES = 16
# the walk's closest hit: each triangle read once (36 B), and a queried
# ray's origin, direction and cap in (28 B), its (t, index) out (8 B)
TRIANGLE_BYTES = 36
RAY_IN_BYTES = 28
RAY_OUT_BYTES = 8


def least_seconds(n_bytes: float, ops: float = 0.0) -> float:
    """The larger of the bytes bound and the operations bound."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / FP32_FLOPS)


def k1_call(lanes: int, levels: int, segments: float,
            ops_per_segment: float) -> tuple:
    """(bytes, operations) of one K1 call of `levels` levels over `lanes`
    lanes that traces `segments` segments."""
    return (K1_LANE_BYTES * lanes + K1_LANE_LEVEL_BYTES * lanes * levels,
            ops_per_segment * segments)


def k1_bound_seconds(calls: int, lanes: int, levels_per_call: float,
                     segments: float, ops_per_segment: float) -> float:
    """The least time of `calls` K1 calls that trace `segments` segments
    in all."""
    if calls <= 0:
        return 0.0
    per_call = k1_call(lanes, levels_per_call, segments / calls,
                       ops_per_segment)
    return calls * least_seconds(*per_call)


def closest_hit_bytes(n_triangles: int, rays: float) -> float:
    """Bytes of one closest-hit query of `rays` rays against a mesh."""
    return TRIANGLE_BYTES * n_triangles + (RAY_IN_BYTES + RAY_OUT_BYTES) * rays


def closest_hit_bound_seconds(queries: int, n_triangles: int,
                              rays: float) -> float:
    """The least time of `queries` closest-hit calls (one a level) over
    `rays` queried rays in all: bound by bytes, since the operations
    depend on the data."""
    if queries <= 0:
        return 0.0
    return (queries * TRIANGLE_BYTES * n_triangles
            + (RAY_IN_BYTES + RAY_OUT_BYTES) * rays) / HBM_BYTES_PER_S


def share_percent(bound_s: float, device_s: float):
    """100 x bound / device time; None where nothing ran."""
    if device_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s
