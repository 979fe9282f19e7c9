"""`image_p95_ms.host`: the 95th percentile of the image times, in ms, of
the traced run's images that ran after the profiler stopped (the
profiler slows the images it traces). The host paces an image of
cornellBox (the device idles for most of it), so this tail is the host
loop's and stands beside `paths_per_s` as a per-layer reading."""

import statistics


def read(run):
    times = [1e3 * (u["end"] - u["start"])
             for u in run.units[len(run.traced_units):]]
    if len(times) < 20:
        return None
    return statistics.quantiles(times, n=20)[-1]
