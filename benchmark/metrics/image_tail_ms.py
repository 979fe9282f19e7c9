"""`image_tail_ms` (and `image_tail_ms.<cells>`): the median, in ms, of
what a render does after its window loop: the program's spans
`render.assemble` (the mean over strata and the image's copy to the
host) and `render.check` (the stats, with the host's finiteness check
over the image) of `integrator/regen.render_regen`, summed a render, over
the traced run's renders after the profiler stopped (`_spans.roots`)."""

import statistics

from benchmark.metrics._spans import roots


def read(run):
    renders = roots(run, "render")
    return renders and statistics.median(
        sum(r.ns for r in rest if r.name in ("render.assemble",
                                             "render.check")) / 1e6
        for _, rest in renders)
