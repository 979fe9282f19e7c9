"""`render_setup_ms` (and `render_setup_ms.<cells>`): the median, in ms,
of a render's set-up, the program's span `render.setup`
(`integrator/regen.render_regen`: the options resolved, the scene's
tables packed and uploaded or its mesh context built, the lane state and
window buffers made, to the synchronize before the first window), over
the traced run's renders after the profiler stopped (`_spans.roots`)."""

import statistics

from benchmark.metrics._spans import roots


def read(run):
    renders = roots(run, "render")
    return renders and statistics.median(
        sum(r.ns for r in rest if r.name == "render.setup") / 1e6
        for _, rest in renders)
