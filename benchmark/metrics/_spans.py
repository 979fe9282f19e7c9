"""What the readers of the program's spans share (`utils/spans.py` of
the port): the roots of a traced run's units that ran after the profiler
stopped, the profiler slowing the units it traces."""


def roots(run, name: str):
    """[(root, [the root's other records])] of the program's roots named
    `name` ("render" or "train.step") that started on or after the first
    untraced unit's start and ended by the last unit's end, oldest first.
    None where the program records no spans, or below 20 such roots (10
    renders of a mesh scene, whose images take ~0.8 s)."""
    try:
        from go_raytracer_tpu_torch.utils import spans
    except ImportError:         # a program without spans
        return None
    after = run.units[len(run.traced_units):]
    found = after and spans.trees(name, 1e9 * after[0]["start"],
                                  1e9 * after[-1]["end"])
    least = 10 if name == "render" and "mesh" in run.config else 20
    return found if len(found or ()) >= least else None
