"""`kernels_per_step`: device kernels (copies and fills left out) in the
traced steps, over the steps."""


def read(run):
    t = run.trace
    if t is None or not run.traced_units or not t.n_kernels:
        return None
    return t.n_kernels / len(run.traced_units)
