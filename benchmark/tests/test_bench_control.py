"""The control (the reference in the program's place, in bfloat16) and the
faults planted in the reference come out over the cell's limits, at a
size the CPU holds. On the card at the cells' own sizes:
`python3 benchmark/calibrate.py --workload <cell> --seeds ...`."""

import pytest

from benchmark import calibrate, run as R


def over(readings: dict, limits: dict) -> bool:
    return any(not readings[k] <= v for k, v in limits.items() if k in readings)


@pytest.mark.parametrize("name", ["cornellBox.final", "modelExample.final"])
def test_render_control_and_faults_fail(name):
    cell = R.Cell(name)
    # the cell's own numbers of images and reference renders, on fewer
    # pixels and samples
    cell.config["camera"].update(width=32, samples_per_pixel=64, max_depth=8)
    cell.workload["params"].update(pixels=128)
    got = calibrate.render_readings(R.Run(cell, 2**31 + 5, "cpu"),
                                    2**31 + 5, "cpu")
    limits = cell.workload["limits"]
    assert not over(got["sound"], limits), got["sound"]
    for k in ("control", "half", "dim", "unchanged", "repeated"):
        assert over(got[k], limits), (k, got[k])


def test_train_control_and_faults_fail():
    cell = R.Cell("cornellBox.train")
    cell.workload["params"].update(width=16, batches=4, depth=5)
    got = calibrate.train_readings(R.Run(cell, 2**31 + 5, "cpu"),
                                   2**31 + 5, "cpu")
    limits = cell.workload["limits"]
    for k in ("control", "half", "altered"):
        assert over(got[k], limits), (k, got[k])
