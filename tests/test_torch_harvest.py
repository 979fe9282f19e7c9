"""The port's reverse harvest against the JAX package's Pallas kernel
(`reverse_harvest_levels`, interpret mode) and its accumulator scan.

Exact: both evaluate the same float32 operations in the same order, so
every started-row prefix and every written accumulator slot is equal bit
for bit. Row tails past a row's started count are don't-care (the caller's
base-to-base writes overwrite them), as in tests/test_harvest.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.ops.pallas import harvest as jph
from go_raytracer_tpu_torch.ops import harvest as tph

torch.set_num_threads(2)
MAXC = 1.5


def _window(rs, S, n, refill, p_start=0.3, p_term=0.35, p_clamp=0.3):
    """Merged V/FL records with the real invariants: emission only at
    terminal vertices, starts only in refill levels. FL also carries each
    start's rank within its level (bits 3..), as bounce_fused_q writes."""
    term = rs.uniform(size=(S, n)) < p_term
    V = rs.uniform(0.0, 1.0, size=(S, n, 3)).astype(np.float32)
    V[term] = rs.uniform(0.0, 3.0, size=(int(term.sum()), 3))
    V[term & (rs.uniform(size=(S, n)) < 0.3)] = 0.0
    V[~term & (rs.uniform(size=(S, n)) < 0.1)] = 0.0
    emit = term & (V != 0).any(-1)
    cf = rs.uniform(size=(S, n)) < p_clamp
    st = np.zeros((S, n), bool)
    st[:refill] = rs.uniform(size=(refill, n)) < p_start
    rank = np.cumsum(st, axis=1) - st
    FL = (cf.astype(np.int32) | (emit.astype(np.int32) << 1)
          | (st.astype(np.int32) << 2) | np.where(st, rank << 3, 0))
    return V, FL.astype(np.int32), st


def _jax_rows(V, FL, cadence, refill):
    S, n, _ = V.shape
    shp = (S // cadence, cadence, n)
    comp = lambda c: jnp.asarray(V[..., c].reshape(shp))
    out = jph.reverse_harvest_levels(
        comp(0), comp(1), comp(2), jnp.asarray((FL & 7).reshape(shp)),
        cadence=cadence, refill_levels=refill, max_contribution=MAXC,
        interpret=True)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("S,cadence,refill", [(24, 4, 16), (30, 3, 30)])
def test_rows_match_pallas_started_prefix(S, cadence, refill):
    rs = np.random.default_rng(S)
    n = 1024
    V, FL, st = _window(rs, S, n, refill)
    jr = _jax_rows(V, FL, cadence, refill)
    tr = tph.reverse_harvest_levels_ref(
        *(torch.from_numpy(np.ascontiguousarray(V[..., c])) for c in range(3)),
        torch.from_numpy(FL), refill_levels=refill, max_contribution=MAXC)
    for s in range(refill):
        k = int(st[s].sum())
        for c in range(3):
            np.testing.assert_array_equal(tr[c][s, :k].numpy(), jr[c][s, :k])
            assert not tr[c][s, k:].any()


def test_accumulator_matches_pallas_plus_row_scan():
    """harvest_levels_into (CPU: the plain version) leaves the accumulator
    exactly as the JAX harvest + write_row_ik scan does, over the items
    the window started."""
    rs = np.random.default_rng(7)
    S, cadence, refill, n, item_base = 24, 4, 20, 1024, 5000
    V, FL, st = _window(rs, S, n, refill)
    counts = st.sum(axis=1)
    bases = (item_base + 37 + np.concatenate([[0], np.cumsum(counts)[:-1]])
             ).astype(np.int32)
    end = int(bases[refill - 1] + counts[refill - 1])
    rows_acc = end - item_base + n
    # JAX: compacted rows, then the row scan at base - item_base
    jr = np.stack(_jax_rows(V, FL, cadence, refill), axis=-1)
    ref = np.full((rows_acc, 3), -7.0, np.float32)
    for s in range(refill):
        off = bases[s] - item_base
        ref[off:off + n] = jr[s]
    acc = torch.full((rows_acc, 3), -7.0)
    tph.harvest_levels_into(
        acc, *(torch.from_numpy(np.ascontiguousarray(V[..., c]))
               for c in range(3)),
        torch.from_numpy(FL), torch.from_numpy(bases), item_base=item_base,
        s_run=S, refill_levels=refill, max_contribution=MAXC)
    np.testing.assert_array_equal(acc[:end - item_base].numpy(),
                                  ref[:end - item_base])
    # every started item of the window was written
    assert (acc[37:end - item_base] != -7.0).all()


def test_unwritten_levels_are_identity():
    """Levels past s_run are all-zero records in the JAX window: reading
    only the first s_run levels gives the same rows."""
    rs = np.random.default_rng(3)
    S, refill, n = 16, 12, 512
    V, FL, _ = _window(rs, S, n, refill)
    V[10:] = 0.0
    FL[10:] = 0
    planes = [torch.from_numpy(np.ascontiguousarray(V[..., c]))
              for c in range(3)]
    full = tph.reverse_harvest_levels_ref(
        *planes, torch.from_numpy(FL), refill_levels=refill,
        max_contribution=MAXC)
    cut = tph.reverse_harvest_levels_ref(
        *planes, torch.from_numpy(FL), refill_levels=refill,
        max_contribution=MAXC, s_run=10)
    for a, b in zip(full, cut):
        assert torch.equal(a, b)
