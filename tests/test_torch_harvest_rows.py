"""The port's `reverse_harvest_ref` (queue schedule) against the JAX
package's Pallas kernel `reverse_harvest` in interpret mode, on the windows
of tests/test_harvest.py, and the accumulator after `write_rows_ref`
against the reference's row scan.

Both evaluate the same float32 operations in the same order, so each row's
started prefix agrees to rtol = atol = 1e-6 (the tolerance of
tests/test_harvest.py; in fact bit for bit). Row tails past a row's started
count are don't-care: the caller's base-to-base writes overwrite them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.ops.pallas import harvest as jph
from go_raytracer_tpu_torch.ops import harvest as tph

torch.set_num_threads(2)
MAXC = 1.5


def _make_window(rs, outer, cadence, n, refill_outer, p_start=0.3,
                 p_term=0.35, p_clamp=0.3):
    """Merged V/FL records with the real invariants (the window of
    tests/test_harvest.py in its merged form): emission only at terminal
    vertices, a zero weight there, starts only in refill rows."""
    E = rs.uniform(0.0, 2.0, size=(outer, cadence, n, 3)).astype(np.float32)
    Wt = rs.uniform(0.0, 1.0, size=(outer, cadence, n, 3)).astype(np.float32)
    term = rs.uniform(size=(outer, cadence, n)) < p_term
    V = np.where(term[..., None], E, Wt)
    FL = ((rs.uniform(size=(outer, cadence, n)) < p_clamp).astype(np.int32)
          | (term.astype(np.int32) << 1))
    STs = np.zeros((outer, n), np.int32)
    STs[:refill_outer] = rs.uniform(size=(refill_outer, n)) < p_start
    return V, FL, STs


def _both(V, FL, STs, cadence, refill_outer):
    comp = lambda c: np.ascontiguousarray(V[..., c])
    jr = jph.reverse_harvest(
        *(jnp.asarray(comp(c)) for c in range(3)), jnp.asarray(FL),
        jnp.asarray(STs), cadence=cadence, refill_outer=refill_outer,
        max_contribution=MAXC, interpret=True)
    tr = tph.reverse_harvest_ref(
        *(torch.from_numpy(comp(c)) for c in range(3)), torch.from_numpy(FL),
        torch.from_numpy(STs), cadence=cadence, refill_outer=refill_outer,
        max_contribution=MAXC)
    return [np.asarray(x) for x in jr], [x.numpy() for x in tr]


def _check_prefix(V, FL, STs, cadence, refill_outer):
    jr, tr = _both(V, FL, STs, cadence, refill_outer)
    for r in range(refill_outer):
        k = int(STs[r].sum())
        for c in range(3):
            assert tr[c].shape == (refill_outer, V.shape[2])
            np.testing.assert_allclose(
                np.nan_to_num(tr[c][r, :k], nan=-777.0),
                np.nan_to_num(jr[c][r, :k], nan=-777.0), rtol=1e-6, atol=1e-6)
            assert not tr[c][r, k:].any()


@pytest.mark.parametrize("outer,cadence,n,refill_outer,seed", [
    (6, 4, 512, 3, 0),      # random window
    (5, 1, 1024, 4, 1),     # cadence 1 and a wider pool
])
def test_rows_match_pallas_started_prefix(outer, cadence, n, refill_outer,
                                          seed):
    rs = np.random.default_rng(seed)
    _check_prefix(*_make_window(rs, outer, cadence, n, refill_outer),
                  cadence=cadence, refill_outer=refill_outer)


@pytest.mark.parametrize("case", ["all", "none", "alternating", "tail_run"])
def test_rows_match_pallas_edge_start_masks(case):
    rs = np.random.default_rng(2)
    outer, cadence, n, refill_outer = 4, 2, 512, 2
    V, FL, STs = _make_window(rs, outer, cadence, n, refill_outer)
    STs[:] = 0
    STs[0] = {"all": np.ones(n, bool), "none": np.zeros(n, bool),
              "alternating": np.arange(n) % 2 == 1,
              "tail_run": np.arange(n) >= n - 130}[case]
    STs[1] = rs.uniform(size=n) < 0.5
    _check_prefix(V, FL, STs, cadence=cadence, refill_outer=refill_outer)


def test_rows_clamp_and_nan_parity():
    """A NaN component sum compares false against max_contribution and is
    never rescaled; a large emission under a clamp flag is."""
    rs = np.random.default_rng(3)
    outer, cadence, n, refill_outer = 3, 2, 256, 2
    V, FL, STs = _make_window(rs, outer, cadence, n, refill_outer)
    V[0, 0, 7, 1] = np.nan
    FL[0, 0, 7] |= 2
    V[1, 0, 9] = (50.0, 0.0, 0.0)   # inner level 0: harvested as clamped
    FL[1, 0, 9] = 3
    STs[0, 7] = STs[1, 9] = 1
    _check_prefix(V, FL, STs, cadence=cadence, refill_outer=refill_outer)
    _, tr = _both(V, FL, STs, cadence, refill_outer)
    assert np.isnan(tr[1][0, int(STs[0, :7].sum())])
    got9 = [tr[c][1, int(STs[1, :9].sum())] for c in range(3)]
    np.testing.assert_allclose(got9, (MAXC, 0.0, 0.0), rtol=1e-6)


def test_accumulator_matches_pallas_plus_row_scan():
    """reverse_harvest_into (CPU: the plain version) leaves the accumulator
    exactly as the JAX harvest + write_row scan does, over the items the
    window started, and every started item is written."""
    rs = np.random.default_rng(7)
    outer, cadence, n, refill_outer, item_base = 6, 4, 1024, 5, 5000
    V, FL, STs = _make_window(rs, outer, cadence, n, refill_outer)
    counts = STs.sum(axis=1)
    nis = (item_base + 37 + np.concatenate([[0], np.cumsum(counts)[:-1]])
           ).astype(np.int32)
    end = int(nis[refill_outer - 1] + counts[refill_outer - 1])
    rows_acc = end - item_base + n
    jr, _ = _both(V, FL, STs, cadence, refill_outer)
    jrows = np.stack(jr, axis=-1)
    ref = np.full((rows_acc, 3), -7.0, np.float32)
    for r in range(refill_outer):
        off = nis[r] - item_base
        ref[off:off + n] = jrows[r]
    acc = torch.full((rows_acc, 3), -7.0)
    before = tph.launches_rows
    tph.reverse_harvest_into(
        acc, *(torch.from_numpy(np.ascontiguousarray(V[..., c]))
               for c in range(3)),
        torch.from_numpy(FL), torch.from_numpy(STs), torch.from_numpy(nis),
        item_base=item_base, cadence=cadence, refill_outer=refill_outer,
        max_contribution=MAXC)
    assert tph.launches_rows == before     # no kernel on a CPU tensor
    np.testing.assert_array_equal(acc[:end - item_base].numpy(),
                                  ref[:end - item_base])
    assert (acc[37:end - item_base] != -7.0).all()
    assert (acc[:37] == -7.0).all()


def test_rows_reject_wrong_cadence():
    z = torch.zeros((2, 3, 256))
    with pytest.raises(ValueError, match="cadence"):
        tph.reverse_harvest_ref(z, z, z, z.to(torch.int32),
                                torch.zeros((2, 256), dtype=torch.int32),
                                cadence=2, refill_outer=1,
                                max_contribution=MAXC)
