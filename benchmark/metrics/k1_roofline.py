"""`k1_roofline`: K1's least time over its device time in the traced
images, in %. A call is one `count_dead` launch and its `fused_q_level`
launches (one a level); its bound counts 72 B a lane and 16 B a lane and
level against the operations of the segments it traced
(`benchmark/roofline.py`)."""

from benchmark import roofline


def read(run):
    t = run.trace
    calls = t.kernel_count(r"\bcount_dead\b") if t else 0
    if not calls:
        return None
    levels = t.kernel_count(r"\bfused_q_level\b") / calls
    segments = sum(u["segments"] for u in run.traced_units)
    bound = roofline.k1_bound_seconds(
        calls, run.workload["params"]["lanes"], levels, segments,
        run.config["roofline"]["k1_ops_per_segment"])
    return roofline.share_percent(bound, t.layer_s["k1"])
