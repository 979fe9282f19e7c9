"""`backward_ms`: the median, in ms, of the device's time in a train
step's backward pass (autograd's backward, and zero gradients for the
leaves the render does not read): the count `backward_ms` of the
program's span `train.step` (`parallel/mesh.make_train_step`), read from
timing events that the step's CUDA graph records at its phase
boundaries, over the traced run's steps after the profiler stopped
(`_spans.roots`). None where the steps carry no such count (off the
card)."""

import statistics

from benchmark.metrics._spans import roots


def read(run):
    times = [root.counts["backward_ms"] for root, _ in
             roots(run, "train.step") or () if "backward_ms" in root.counts]
    return statistics.median(times) if len(times) >= 20 else None
