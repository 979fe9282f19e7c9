"""`graph_launch_ms`: the median, in ms, of a train step's launch, the
program's span `train.launch` (`parallel/mesh.make_train_step`: the
replay of the step's CUDA graph, or its eager body), over the traced
run's steps after the profiler stopped (`_spans.roots`). The loss read
that waits for the device is its own span and not counted."""

import statistics

from benchmark.metrics._spans import roots


def read(run):
    steps = roots(run, "train.step")
    return steps and statistics.median(
        sum(r.ns for r in rest if r.name == "train.launch") / 1e6
        for _, rest in steps)
