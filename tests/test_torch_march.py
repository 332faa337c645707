"""The ray-march kernel's schedule on the CPU: ``march_grouped_ref`` (rounds
of speculative steps, then the first hit) against ``march_ref`` (one step
at a time), bit for bit.

Every ray case of ``kernels/march/cases.py`` on Fig. 19's grid and on a
70 x 130 grid without walls, from fresh rays and from the partly ended
state a chunk leaves, at each of ``STEP_COUNTS`` and every step of a 6 m
cast, at rounds of 1, 4, 8, 16 and 32 steps.  No JAX: ``march_ref``
itself is held against the reference in ``test_torch_mcl.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import mcl as tmcl
from repro_torch.kernels.march.cases import (FIG19_GRID_SEED, STEP_COUNTS,
                                             nonsquare_grid, ray_cases,
                                             start_states)
from repro_torch.kernels.march.ref import march_grouped_ref, march_ref

MAX_RANGE = 6.0
GROUPS = (1, 4, 8, 16, 32)


def _grid(name):
    if name == "fig19":
        return tmcl.make_corridor_world(FIG19_GRID_SEED, size=192,
                                        device="cpu")
    return tmcl.OccupancyGrid(occ=torch.from_numpy(nonsquare_grid()),
                              cell=0.05)


@pytest.fixture(scope="module")
def marched():
    """(grid name, case, start, n) -> (grid, dirv, start state, march_ref's
    state after n steps), for every case of the module's docstring."""
    out = {}
    for name in ("fig19", "nonsquare"):
        grid = _grid(name)
        steps = int(np.ceil(MAX_RANGE / grid.cell)) + 1
        for case, (org, ang) in ray_cases(grid.shape, grid.cell).items():
            dirv = tmcl.ray_directions(torch.from_numpy(ang))
            states = start_states(grid.occ, grid.origin, grid.cell, org,
                                  dirv, MAX_RANGE)
            for start, st in states.items():
                for n in STEP_COUNTS + (steps,):
                    want = tuple(x.clone() for x in st)
                    march_ref(grid.occ, grid.origin, grid.cell, want[0],
                              dirv, want[1], want[2], MAX_RANGE, n)
                    out[name, case, start, n] = (grid, dirv, st, want)
    return out


@pytest.mark.parametrize("group", GROUPS)
def test_grouped_march_matches_step_by_step(marched, group):
    for (name, case, start, n), (grid, dirv, st, want) in marched.items():
        got = tuple(x.clone() for x in st)
        march_grouped_ref(grid.occ, grid.origin, grid.cell, got[0], dirv,
                          got[1], got[2], MAX_RANGE, n, group)
        for a, b in zip(got, want):
            assert torch.equal(a, b), (name, case, start, n, group)


def test_cases_reach_what_they_are_for(marched):
    """The chunk's state is partly ended with ``dist`` past 0;
    ``first_hit`` rays end on every step 0..63 of a cast on both grids; a
    whole cast ends every ray; ``one`` is one ray."""
    _, _, st, _ = marched["fig19", "scan", "chunk", 1]
    assert 0 < int(st[2].sum()) < len(st[2]) and bool((st[1] > 0).all())
    for name in ("fig19", "nonsquare"):
        grid, _, _, want = marched[name, "first_hit", "fresh", 121]
        ends = torch.round(want[1] / grid.cell).to(torch.int64) - 1
        assert set(range(64)) <= set(ends.tolist()), name
    for key, (_, _, _, want) in marched.items():
        if key[3] == 121:
            assert not bool(want[2].any()), key
    assert len(marched["fig19", "one", "fresh", 1][1]) == 1


def test_grouped_march_rejects_an_empty_group():
    grid = _grid("nonsquare")
    pos, dirv = torch.zeros((2, 2)), torch.ones((2, 2))
    with pytest.raises(ValueError, match="group"):
        march_grouped_ref(grid.occ, grid.origin, grid.cell, pos, dirv,
                          torch.zeros(2), torch.ones(2, dtype=torch.bool),
                          MAX_RANGE, 4, 0)
