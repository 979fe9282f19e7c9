"""`window_host_us` (and `window_host_us.<cells>`): the host's own time a
kernel call of the window loop, in us. The program's span
`render.windows` (`integrator/regen.render_regen` around
`_window_pipeline`, to its last synchronize) less the host's waits on
the device in it, which are its child spans `render.sync` (the reads of
each window's counts, the synchronize after the last) and its count
`wait_ns` (the mesh path's polls of a level `RUN_AHEAD` levels back),
and less each level graph's capture (`render.capture`), summed over the
traced run's renders after the profiler stopped (`_spans.roots`), over
the span's `calls` summed over the same renders: K1 calls on the fused
path, levels run on the mesh path. None where no call ran."""

from benchmark.metrics._spans import roots


def read(run):
    renders = roots(run, "render")
    if renders is None:
        return None
    from go_raytracer_tpu_torch.utils.spans import self_ns

    own, calls = 0, 0
    for _, rest in renders:
        for loop in rest:
            if loop.name == "render.windows":
                own += self_ns(loop, rest) - loop.counts.get("wait_ns", 0)
                calls += loop.counts["calls"]
    return own / 1e3 / calls if calls else None
