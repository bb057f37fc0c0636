"""The grouped-sum wrapper of the port's scan-aggregate route on the CPU.

``grouped_sums`` takes its value rows as one ``[K, n]`` tensor or as a list
of K ``[n]`` tensors (the route's form): both must give ``np.add.at``'s sums,
also past the kernel's MAX_ROWS row pointers, and rows that break the
contract (length, dtype, device, layout) must raise. ``_plan``, the pure
placement arithmetic the CUDA launcher executes, is held to its contract at
every (K, G) the route can give and up to the contract's largest grid
(``K x (G + 1) < 2^31``): each cell of the ``[K, G + 1]`` grid owned by
exactly one block of a launch, every block's share within the shared
memory a block may take, clusters of 1 to 8 blocks (the kernel's portable
limit) or the grid in ``out`` itself past a cluster of two, enough
clusters for every slice of rows.
"""

import numpy as np
import pytest
import torch

from databend_tpu_torch.ops import grouped_sums as tgs


def _rows(n, k, groups, seed):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, groups + 1, n).astype(np.int32)
    rows = rng.integers(-255, 256, (k, n)).astype(np.int32)
    want = np.zeros((k, groups + 1), np.int64)
    for r in range(k):
        np.add.at(want[r], gid, rows[r])
    return gid, rows, want


@pytest.mark.parametrize("n,k,groups", [(1, 1, 0), (1000, 3, 1),
                                        (257, 2, 64), (5000, 7, 12),
                                        (3000, 4, 500), (4000, 20, 10_001),
                                        (2000, 6, 10_001)])
def test_list_form_equals_stacked_and_add_at(n, k, groups):
    gid, rows, want = _rows(n, k, groups, n + k)
    tg = torch.from_numpy(gid)
    stacked = tgs.grouped_sums(tg, torch.from_numpy(rows), groups)
    listed = tgs.grouped_sums(tg, [torch.from_numpy(r.copy()) for r in rows],
                              groups)
    assert listed.dtype == torch.int32 and listed.shape == (k, groups + 1)
    np.testing.assert_array_equal(listed.numpy(), want)
    assert torch.equal(listed, stacked)


@pytest.mark.parametrize("k", [tgs.MAX_ROWS + 1, 2 * tgs.MAX_ROWS + 3])
def test_rows_past_the_pointer_cap(k):
    """More value rows than one launch takes: the plan cuts them into
    launches of at most MAX_ROWS rows, and the sums stay exact."""
    n, groups = 700, 40
    gid, rows, want = _rows(n, k, groups, k)
    got = tgs.grouped_sums(torch.from_numpy(gid),
                           [torch.from_numpy(r.copy()) for r in rows], groups)
    np.testing.assert_array_equal(got.numpy(), want)
    plan = tgs._plan(n, k, groups, 132)
    assert len(plan) == -(-k // tgs.MAX_ROWS)
    assert [(l.k_lo, l.k_hi) for l in plan] == [
        (lo, min(k, lo + tgs.MAX_ROWS)) for lo in range(0, k, tgs.MAX_ROWS)]


def test_no_rows():
    gid = torch.zeros(5, dtype=torch.int32)
    assert tgs.grouped_sums(gid, [], 3).shape == (0, 4)


def _bad_rows(kind, n):
    ok = torch.zeros(n, dtype=torch.int32)
    return {"length": [ok, torch.zeros(n + 1, dtype=torch.int32)],
            "dtype": [ok, torch.zeros(n, dtype=torch.int64)],
            "device": [ok, torch.zeros(n, dtype=torch.int32, device="meta")],
            "strided": [ok, torch.zeros(2 * n, dtype=torch.int32)[::2]],
            "two_dim": [ok, torch.zeros((1, n), dtype=torch.int32)],
            "not_a_tensor": [ok, np.zeros(n, np.int32)],
            "block_transposed": torch.zeros((n, 2), dtype=torch.int32).t(),
            "block_length": torch.zeros((2, n + 1), dtype=torch.int32)}[kind]


@pytest.mark.parametrize("kind,error", [
    ("length", ValueError), ("dtype", TypeError), ("device", ValueError),
    ("strided", ValueError), ("two_dim", ValueError),
    ("not_a_tensor", ValueError), ("block_transposed", ValueError),
    ("block_length", ValueError)])
def test_invalid_rows_raise(kind, error):
    gid = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(error):
        tgs.grouped_sums(gid, _bad_rows(kind, 6), 2)


def test_invalid_gid_and_groups_raise():
    rows = [torch.zeros(4, dtype=torch.int32)]
    with pytest.raises(TypeError):
        tgs.grouped_sums(torch.zeros(4, dtype=torch.int64), rows, 1)
    with pytest.raises(ValueError):
        tgs.grouped_sums(torch.zeros((2, 2), dtype=torch.int32), rows, 1)
    with pytest.raises(ValueError):
        tgs.grouped_sums(torch.zeros(4, dtype=torch.int32), rows, -1)
    with pytest.raises(ValueError):
        tgs.grouped_sums(torch.zeros(4, dtype=torch.int32), rows * 2,
                         (1 << 30) - 1)


def _card_occupancy(cluster, threads, smem):
    """The co-resident clusters of the kernel as an H100 80GB HBM3 gives
    them through cudaOccupancyMaxActiveClusters at one block an SM
    (clusters are placed within GPCs: fewer than the SMs allow)."""
    per_sm = min(2048 // threads, 233_472 // (smem + 1_024))
    if cluster in (1, tgs.GLOBAL):
        return 132 * per_sm
    at_one = {2: 66, 4: 30, 8: 15, 16: 7}[cluster]
    return at_one * per_sm


def _scarce_occupancy(cluster, threads, smem):
    """One cluster at a time: slices outnumber the clusters that fit."""
    return 1


def _check_launch(launch, G1):
    """The launch is one the kernel's launcher accepts: a cluster of 1 to 8
    blocks whose [R, W] share fits a block's shared memory, or the grid in
    out (one slice of every row, every column); enough clusters for every
    slice; no slice and no block without a cell."""
    C, S, R, W = launch.cluster, launch.slices, launch.rows, launch.width
    k = launch.k_hi - launch.k_lo
    assert 1 <= k <= tgs.MAX_ROWS
    assert launch.threads % 32 == 0 and 32 <= launch.threads <= 1024
    assert k * G1 < 1 << 31
    if C == tgs.GLOBAL:
        assert launch.placement == "global"
        assert (S, R, W) == (1, k, G1) and launch.blocks >= 1
        return
    assert 1 <= C <= 8 and C in tgs.CLUSTERS
    assert 4 * R * W <= tgs.SMEM_BLOCK
    assert launch.blocks % C == 0
    clusters = launch.blocks // C
    assert clusters >= S and clusters % S == 0
    assert -(-k // R) == S                     # no empty slice
    assert W * (C - 1) < G1 <= W * C           # every block owns a column


@pytest.mark.parametrize("occupancy", [None, _card_occupancy,
                                       _scarce_occupancy],
                         ids=["model", "card", "scarce"])
@pytest.mark.parametrize("groups", [1, 12, 64, 65, 10_001, 65_536])
@pytest.mark.parametrize("k", [1, 6, 20, 64, 65])
def test_plan_owns_every_cell_once(k, groups, occupancy):
    n = 6_000_000
    G1 = groups + 1
    owned = np.zeros((k, G1), np.int64)
    plan = tgs._plan(n, k, groups, 132, occupancy)
    for launch in plan:
        _check_launch(launch, G1)
        C, S, R, W = launch.cluster, launch.slices, launch.rows, launch.width
        for s in range(S):
            lo = launch.k_lo + s * R
            hi = min(launch.k_hi, lo + R)
            for rank in range(C):
                owned[lo:hi, rank * W:min(G1, (rank + 1) * W)] += 1
    assert (owned == 1).all()
    assert plan[-1].k_hi == k


@pytest.mark.parametrize("groups", [1, 12, 64, 65, 1000, 10_001, 58_111,
                                    58_112, 65_536, 116_223, 116_224,
                                    1 << 20])
@pytest.mark.parametrize("k", [1, 6, 21])
def test_plan_keeps_adds_local_where_a_row_fits(k, groups):
    """The measured rule: the whole grid in one block where it fits (two
    hundred fifty-six threads a block, eight blocks an SM, for the mask
    engine's grids), else the rows sliced over single blocks while one row
    fits a block, else a cluster of two blocks (the matmul engine's largest
    grids), else the grid in out."""
    (launch,) = tgs._plan(6_000_000, k, groups, 132, _card_occupancy)
    G1 = groups + 1
    if 4 * k * G1 <= tgs._budget(8):
        assert (launch.placement, launch.threads) == ("block", 256)
    elif 4 * G1 <= tgs.SMEM_BLOCK:
        assert launch.cluster == 1
        if 4 * k * G1 > tgs.SMEM_BLOCK:
            assert launch.placement == "k_split"
    elif 4 * G1 <= 2 * tgs.SMEM_BLOCK:
        assert launch.cluster == 2
    else:
        assert launch.placement == "global"


def test_plan_by_shape_alone():
    """Only the block count follows n: fewer rows, fewer clusters."""
    big = tgs._plan(8_000_000, 20, 10_001, 132)[0]
    small = tgs._plan(5_000, 20, 10_001, 132)[0]
    assert big._replace(blocks=0) == small._replace(blocks=0)
    assert small.blocks < big.blocks
    assert tgs._plan(1, 20, 10_001, 132)[0].blocks == \
        big.slices * big.cluster


def _contract_shapes():
    """(K, G) past the two-block cluster up to the contract's largest grid,
    K x (G + 1) < 2^31, at K of 1, 6, 20, 64 and 65."""
    shapes = []
    for k in (1, 6, 20, 64, 65):
        largest = ((1 << 31) - 1) // k - 1
        shapes += [(k, g) for g in (116_223, 116_224, 929_791, 929_792,
                                    1 << 20, 1 << 24) if g < largest]
        shapes.append((k, largest))
    return shapes


@pytest.mark.parametrize("k,groups", _contract_shapes())
def test_plan_covers_the_contract(k, groups):
    """Every (K, G) of the contract has a placement, past the two-block
    cluster too (the route's caps go up to 2^24 groups): the launches
    cover the rows in order and own every cell once, the grid in out
    wherever one row is wider than two blocks' shared memory."""
    G1 = groups + 1
    for occupancy in (None, _card_occupancy, _scarce_occupancy):
        plan = tgs._plan(6_000_000, k, groups, 132, occupancy)
        assert [(l.k_lo, l.k_hi) for l in plan] == [
            (lo, min(k, lo + tgs.MAX_ROWS))
            for lo in range(0, k, tgs.MAX_ROWS)]
        for launch in plan:
            _check_launch(launch, G1)
            assert (launch.placement == "global") == \
                (4 * G1 > 2 * tgs.SMEM_BLOCK)


def test_global_placement_sums():
    """The plan's global placement on a CPU tensor still runs the plain
    version: the sums at such a grid equal np.add.at."""
    n, k, groups = 3000, 3, 150_000
    gid, rows, want = _rows(n, k, groups, 5)
    (launch,) = tgs._plan(n, k, groups, 132)
    assert launch.placement == "global" and launch.blocks == 3
    got = tgs.grouped_sums(torch.from_numpy(gid),
                           [torch.from_numpy(r.copy()) for r in rows], groups)
    np.testing.assert_array_equal(got.numpy(), want)
