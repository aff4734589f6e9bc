"""The port's assignment solvers (cfm_tpu_torch/ops/auction.py, assignment.py)
against JAX.

The dense auction's plain version must give the identical permutation to
``cfm_tpu.ops.pallas_auction.auction_assignment_onehot_xla``, the JAX
package's own CPU oracle for the TPU kernels (which have no interpret
switch), on random and tied costs; so must the row-tiled auction's plain
version, at small row tiles, with the dense version's round count. The
scatter auction, the completion of partial matchings and the dispatch rules
are held against JAX too, and every permutation's cost against the JV
optimum of ``lap_solve`` to 1e-5 relative. The CUDA kernels are checked
against their plain versions by the ``cuda``-marked tests, which skip
without a card. The JAX package is imported inside the tests that use it.

``_kernel_model`` is the dense kernel (``csrc/auction.cu``) in numpy: its
in-launch epsilon schedule, its one-pass (best, first column, second) scan
in the warp's reduction order (lane l folds columns l, l + 32, ..., then a
butterfly merges the lanes), its bids and per-column winners, and its
completion of a partial matching. It must give the plain version's and
JAX's permutation and round count.
"""

import numpy as np
import pytest
import torch

from cfm_tpu_torch.ops import assignment as tas
from cfm_tpu_torch.ops import auction as tau


def _cost(n, kind, seed=0):
    """An (n, n) f32 cost: squared distances of Gaussian clouds, small
    integers (heavy ties), duplicate rows and columns, or rank 1."""
    rng = np.random.default_rng(seed)
    if kind == "gauss":
        a, b = rng.standard_normal((n, 5)), rng.standard_normal((n, 5))
        c = ((a[:, None] - b[None]) ** 2).sum(-1)
    elif kind == "ties":
        c = rng.integers(0, 3, (n, n))
    elif kind == "dups":
        a = rng.standard_normal((n, 3))
        a[1::2] = a[::2][: n // 2]
        c = ((a[:, None] - a[None, ::-1]) ** 2).sum(-1)
    else:  # rank 1: every row the same gaps
        c = np.outer(np.ones(n), np.arange(n))
    return c.astype(np.float32)


def _jax_onehot(c):
    import jax.numpy as jnp

    from cfm_tpu.ops.pallas_auction import auction_assignment_onehot_xla

    return np.asarray(auction_assignment_onehot_xla(jnp.asarray(c)))


@pytest.mark.parametrize("kind", ["gauss", "ties"])
@pytest.mark.parametrize("n", [2, 8, 33, 64, 128])
def test_plain_auction_equals_jax_onehot_oracle(n, kind):
    c = _cost(n, kind)
    perm, rounds = tau.auction_assignment_onehot(torch.from_numpy(c))
    assert perm.dtype == torch.long and rounds > 0
    np.testing.assert_array_equal(perm.numpy(), _jax_onehot(c))


@pytest.mark.parametrize("kind", ["dups", "rank1"])
def test_plain_auction_equals_jax_on_degenerate_costs(kind):
    c = _cost(32, kind, seed=1)
    perm, _ = tau.auction_assignment_onehot(torch.from_numpy(c))
    np.testing.assert_array_equal(perm.numpy(), _jax_onehot(c))
    assert sorted(perm.tolist()) == list(range(32))


_F32 = np.float32
_NEG32 = _F32(-3.0e38)


def _kernel_eps(benefit, num_phases):
    """The kernel's schedule: max and min over every entry, then
    max(max - min, 1e-12) * 0.5, divided by 4^(phases - 1) built by f32
    multiplications."""
    eps0 = _F32(np.maximum(_F32(benefit.max() - benefit.min()), _F32(1e-12)) * _F32(0.5))
    div = _F32(1.0)
    for _ in range(num_phases - 1):
        div = _F32(div * _F32(4.0))
    return eps0, _F32(eps0 / div)


def _one_pass_scan(values):
    """(best, first column, second) of each row of ``values`` (B, n) in the
    kernel's order: lane l folds columns l, l + 32, ... (a larger value
    moves the best to the second, an equal or smaller one joins the second),
    then a butterfly over lane distances 16 .. 1 keeps the larger best, the
    smaller column on a tie, and the loser's best joins the second."""
    B, n = values.shape
    T = -(-n // 32)
    pad = np.full((B, 32 * T), -np.inf, np.float32)
    pad[:, :n] = values
    lanes = pad.reshape(B, T, 32)
    v1 = np.full((B, 32), -np.inf, np.float32)
    j1 = np.full((B, 32), n)
    v2 = np.full((B, 32), _NEG32)
    for t in range(T):
        v, j = lanes[:, t, :], 32 * t + np.arange(32)[None, :]
        valid = j < n
        better = valid & (v > v1)
        v2 = np.where(better, np.maximum(v2, v1), np.where(valid, np.maximum(v2, v), v2))
        v1, j1 = np.where(better, v, v1), np.where(better, j, j1)
    for o in (16, 8, 4, 2, 1):
        p = np.arange(32) ^ o
        ov1, oj1, ov2 = v1[:, p], j1[:, p], v2[:, p]
        take = (ov1 > v1) | ((ov1 == v1) & (oj1 < j1))
        v2 = np.where(take, np.maximum(ov2, v1), np.maximum(v2, ov1))
        v1, j1 = np.where(take, ov1, v1), np.where(take, oj1, j1)
    return v1[:, 0], j1[:, 0], v2[:, 0]


def _complete(assign, owner):
    """The kernel's completion at the round cap: the k-th unassigned row
    takes the k-th unowned column."""
    assign, owner = assign.copy(), owner.copy()
    j = 0
    for i in range(len(assign)):
        if assign[i] >= 0:
            continue
        while owner[j] >= 0:
            j += 1
        assign[i], owner[j] = j, i
    return assign


def _kernel_model(cost, num_phases=12):
    """The dense kernel in numpy: (perm, rounds, row scans)."""
    n = cost.shape[0]
    benefit = -cost.astype(np.float32)
    eps, eps_final = _kernel_eps(benefit, num_phases)
    price = np.zeros(n, np.float32)
    owner, assign = np.full(n, -1), np.full(n, -1)
    rounds, scans, cap = 0, 0, 200 * n + 20000
    while (assign < 0).any() and rounds < cap:
        rows = np.nonzero(assign < 0)[0]
        v1, j1, v2 = _one_pass_scan(benefit[rows] - price[None, :])
        bid = (price[j1] + (v1 - v2)) + eps          # f32, rounded at each step
        scans += len(rows)
        best = {}
        for r, j, b in zip(rows, j1, bid):           # ascending rows: the first wins ties
            if b > _NEG32 and (j not in best or b > best[j][0]):
                best[j] = (b, r)
        for j, (b, r) in best.items():
            if owner[j] >= 0:
                assign[owner[j]] = -1
            owner[j], assign[r], price[j] = r, j, b
        rounds += 1
        if (assign >= 0).all() and eps > eps_final:
            eps = _F32(eps / _F32(4.0))
            owner[:], assign[:] = -1, -1
    return _complete(assign, owner), rounds, scans


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the plain versions' thousands of small ops:
    under the suite's parallel workers, OpenMP's fork-join barriers
    otherwise stall each op (an n = 256 solve ran minutes, not seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n", [1, 7, 32, 100, 256])
def test_one_pass_scan_matches_the_two_pass_definition(n):
    """The first column among the maxima, and the max over every other
    column (the best itself on a tie, -3e38 for a single column)."""
    rng = np.random.default_rng(n)
    for values in (rng.standard_normal((9, n)).astype(np.float32),
                   rng.integers(0, 3, (9, n)).astype(np.float32)):
        v1, j1, v2 = _one_pass_scan(values)
        best = values.max(axis=1)
        first = np.argmax(values == best[:, None], axis=1)
        masked = values.copy()
        masked[np.arange(9), first] = _NEG32
        np.testing.assert_array_equal(v1, best)
        np.testing.assert_array_equal(j1, first)
        np.testing.assert_array_equal(v2, masked.max(axis=1) if n > 1 else np.full(9, _NEG32))


@pytest.mark.parametrize("phases", [1, 12, 20])
@pytest.mark.parametrize("kind", ["gauss", "ties", "const"])
def test_kernel_eps_schedule_has_the_bits_of_eps_schedule(kind, phases):
    import jax.numpy as jnp

    c = np.full((8, 8), 3.25, np.float32) if kind == "const" else _cost(40, kind, seed=11)
    eps0, eps_final = _kernel_eps(-c, phases)
    ref0, ref_final = tau._eps_schedule(-torch.from_numpy(c), phases)
    assert eps0.view(np.int32) == ref0.numpy().view(np.int32)
    assert eps_final.view(np.int32) == ref_final.numpy().view(np.int32)
    b = -jnp.asarray(c)  # auction_assignment_onehot_xla's steps
    j0 = jnp.maximum(jnp.max(b) - jnp.min(b), 1e-12) / 2.0
    assert eps0.view(np.int32) == np.asarray(j0).view(np.int32)
    assert eps_final.view(np.int32) == np.asarray(j0 / (4.0 ** (phases - 1))).view(np.int32)


@pytest.mark.parametrize("n,unassigned", [(1, 1), (6, 2), (17, 5), (64, 64), (64, 1)])
def test_kernel_completion_matches_sanitize_perm(n, unassigned):
    """A consistent partial matching (what the kernel holds at the round
    cap), completed in the kernel's serial order, against ``_sanitize_perm``
    of the sentinel perm in the port and in JAX."""
    import jax.numpy as jnp

    from cfm_tpu.ops.pallas_auction import _sanitize_perm

    rng = np.random.default_rng(n + unassigned)
    assign = rng.permutation(n)
    assign[rng.choice(n, unassigned, replace=False)] = -1
    owner = np.full(n, -1)
    owner[assign[assign >= 0]] = np.nonzero(assign >= 0)[0]
    got = _complete(assign, owner)
    sentinel = np.where(assign >= 0, assign, n).astype(np.int32)
    np.testing.assert_array_equal(got, tau._sanitize_perm(torch.from_numpy(sentinel), n).numpy())
    np.testing.assert_array_equal(got, np.asarray(_sanitize_perm(jnp.asarray(sentinel), n)))
    assert sorted(got.tolist()) == list(range(n))


@pytest.mark.parametrize("kind", ["gauss", "ties", "dups", "rank1"])
@pytest.mark.parametrize("n", [2, 33, 64, 128])
def test_kernel_model_equals_plain_and_jax(n, kind):
    c = _cost(n, kind, seed=12)
    perm, rounds, scans = _kernel_model(c)
    ref, ref_rounds = tau.auction_assignment_onehot(torch.from_numpy(c))
    np.testing.assert_array_equal(perm, ref.numpy())
    assert rounds == ref_rounds and scans >= n
    np.testing.assert_array_equal(perm, _jax_onehot(c))


def test_kernel_model_equals_plain_at_256():
    c = _cost(256, "gauss", seed=13)
    perm, rounds, _ = _kernel_model(c)
    ref, ref_rounds = tau.auction_assignment_onehot(torch.from_numpy(c))
    np.testing.assert_array_equal(perm, ref.numpy())
    assert rounds == ref_rounds


@pytest.mark.parametrize("perm", [
    [0, 1, 2, 3, 4, 5],      # complete
    [6, 1, 6, 3, 6, 5],      # rows left unowned (sentinel n)
    [2, 2, 0, 3, 3, 1],      # duplicate claims: first owner keeps the column
    [-1, 4, 4, 9, 0, 5],     # negative, duplicate and out of range
    [5, 4, 3, 2, 1, 0],
])
def test_sanitize_perm_matches_jax(perm):
    import jax.numpy as jnp

    from cfm_tpu.ops.pallas_auction import _sanitize_perm

    ref = np.asarray(_sanitize_perm(jnp.asarray(perm, jnp.int32), 6))
    out = tau._sanitize_perm(torch.tensor(perm, dtype=torch.int32), 6)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert sorted(out.tolist()) == list(range(6))


@pytest.mark.parametrize("p2o,o2p", [
    ([1, -1, 0, -1], [2, 0, -1, -1]),
    ([-1, -1, -1, -1], [-1, -1, -1, -1]),
    ([3, 2, 1, 0], [3, 2, 1, 0]),
])
def test_complete_assignment_matches_jax(p2o, o2p):
    import jax.numpy as jnp

    from cfm_tpu.ops.assignment import _complete_assignment

    ref = np.asarray(_complete_assignment(jnp.asarray(p2o, jnp.int32), jnp.asarray(o2p, jnp.int32)))
    out = tau._complete_assignment(torch.tensor(p2o), torch.tensor(o2p))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("kind", ["gauss", "ties"])
@pytest.mark.parametrize("n", [8, 64])
def test_scatter_auction_equals_jax(n, kind):
    import jax.numpy as jnp

    from cfm_tpu.ops.assignment import auction_assignment

    c = _cost(n, kind, seed=2)
    ref = np.asarray(auction_assignment(jnp.asarray(c)))
    np.testing.assert_array_equal(tas.auction_assignment(torch.from_numpy(c)).numpy(), ref)
    # The rounds it reports are the dense plain version's, which runs the same bids.
    _, rounds = tau.auction_assignment_onehot(torch.from_numpy(c))
    assert tas.auction_assignment.last_rounds == rounds


@pytest.mark.parametrize("n", [16, 128])
def test_assignment_costs_match_the_jv_optimum(n):
    from cfm_tpu.ops.native import lap_solve

    c = _cost(n, "gauss", seed=3)
    col, _ = lap_solve(c.astype(np.float64))
    opt = float(c[np.arange(n), col].sum())
    ct = torch.from_numpy(c)
    for method in ("auction", "hungarian", "pallas"):
        perm = tas.solve_assignment(ct, method)
        got = float(tas.assignment_cost(ct, perm))
        assert abs(got - opt) <= 1e-5 * abs(opt), (method, got, opt)


def test_resolve_solver_follows_the_jax_rules():
    assert tas.resolve_solver("auto", 128, "cpu") == "hungarian"
    assert tas.resolve_solver("auto", 128, "cuda") == "pallas"
    assert tas.resolve_solver("auto", 512, "cuda") == "pallas"
    assert tas.resolve_solver("auto", 1024, "cuda") == "pallas_tiled"
    assert tas.resolve_solver("auto", 4096, "cuda") == "pallas_tiled"
    assert tas.resolve_solver("auto", 600, "cuda") == "auction"
    assert tas.resolve_solver("auction", 128, "cuda") == "auction"
    c = torch.from_numpy(_cost(256, "gauss", seed=6))
    assert torch.equal(tas.solve_assignment(c, "pallas_tiled"),
                       tau.auction_assignment_tiled_reference(c)[0])
    with pytest.raises(ValueError, match="Unknown"):
        tas.solve_assignment(torch.zeros(4, 4), "simplex")


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    c = torch.from_numpy(_cost(16, "gauss", seed=4))
    before = tau.pallas_auction_assignment.launches
    assert torch.equal(tau.pallas_auction_assignment(c), tau.auction_assignment_onehot(c)[0])
    assert tau.pallas_auction_assignment.launches == before


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError, match="square"):
        tau.pallas_auction_assignment(torch.zeros(3, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        tau.pallas_auction_assignment(torch.zeros(4, 4, device="meta"))


@pytest.mark.parametrize("kind", ["gauss", "ties", "dups", "rank1"])
@pytest.mark.parametrize("n,tile", [(64, 16), (128, 32)])
def test_tiled_plain_auction_equals_jax_onehot_oracle(n, tile, kind):
    """Row tiles of 16 and 32: the permutation of the JAX oracle and the
    dense plain version's round count (the TPU kernels share the round)."""
    c = _cost(n, kind, seed=7)
    perm, rounds = tau.auction_assignment_tiled_reference(torch.from_numpy(c), tile=tile)
    assert perm.dtype == torch.long and sorted(perm.tolist()) == list(range(n))
    np.testing.assert_array_equal(perm.numpy(), _jax_onehot(c))
    assert rounds == tau.auction_assignment_onehot(torch.from_numpy(c))[1]


def test_tiled_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    c = torch.from_numpy(_cost(256, "gauss", seed=8))
    before = tau.pallas_auction_assignment_tiled.launches
    ref, _ = tau.auction_assignment_tiled_reference(c)
    assert torch.equal(tau.pallas_auction_assignment_tiled(c), ref)
    assert tau.pallas_auction_assignment_tiled.launches == before


def test_tiled_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError, match="square"):
        tau.pallas_auction_assignment_tiled(torch.zeros(256, 512))
    for n in (0, 384, 4224 + 64):  # the JAX kernel's assert: n a multiple of its tile
        with pytest.raises(ValueError, match="multiple of"):
            tau.pallas_auction_assignment_tiled(torch.zeros(n, n))
    with pytest.raises(ValueError, match="multiple of the row tile 32"):
        tau.auction_assignment_tiled_reference(torch.zeros(48, 48), tile=32)
    with pytest.raises(ValueError, match="unsupported device"):
        tau.pallas_auction_assignment_tiled(torch.zeros(256, 256, device="meta"))


def _merge(a, b):
    """``merge`` of auction_common.cuh on arrays of partials (best, first
    column, second): the larger best, the smaller column on a tie, the
    loser's best joins the second."""
    v1, j1, v2 = a
    ov1, oj1, ov2 = b
    take = (ov1 > v1) | ((ov1 == v1) & (oj1 < j1))
    return (np.where(take, ov1, v1), np.where(take, oj1, j1),
            np.where(take, np.maximum(ov2, v1), np.maximum(v2, ov1)))


_NO_COL = np.iinfo(np.int32).max


def _slice_partials(values, w, acc):
    """The tiled kernel's partials of each row of ``values`` (B, n): w warps
    each take a contiguous slice of n / w columns; in a slice, lane l's
    accumulator a folds float4s l + 32 a, l + 32 (a + acc), ... (each float4's
    four columns in order), as ``scan_slice`` does. Returns the (B, w * 32 *
    acc) partials, an empty accumulator (-inf, no column, -3e38)."""
    B, n = values.shape
    L = n // w
    K = -(-L // (4 * 32 * acc))
    pad = np.full((B, w, K * acc * 32 * 4), -np.inf, np.float32)
    pad[:, :, :L] = values.reshape(B, w, L)
    cols = np.full((w, K * acc * 32 * 4), _NO_COL)
    cols[:, :L] = np.arange(n).reshape(w, L)
    # element ((k acc + a) 32 + lane) 4 + c -> chain position k 4 + c of (lane, a)
    v = pad.reshape(B, w, K, acc, 32, 4).transpose(0, 1, 4, 3, 2, 5).reshape(B, w, 32, acc, 4 * K)
    c = cols.reshape(w, K, acc, 32, 4).transpose(0, 3, 2, 1, 4).reshape(w, 32, acc, 4 * K)
    v1 = np.full((B, w, 32, acc), -np.inf, np.float32)
    j1 = np.full((B, w, 32, acc), _NO_COL)
    v2 = np.full((B, w, 32, acc), _NEG32)
    for t in range(4 * K):  # fold(): a larger value moves the best to the second
        x, j = v[..., t], np.broadcast_to(c[..., t], v1.shape)
        valid = j != _NO_COL
        better = valid & (x > v1)
        v2 = np.where(better, np.maximum(v2, v1), np.where(valid, np.maximum(v2, x), v2))
        v1, j1 = np.where(better, x, v1), np.where(better, j, j1)
    return v1.reshape(B, -1), j1.reshape(B, -1), v2.reshape(B, -1)


def _merged(parts, order):
    """Merge the partials (B, P) one after the other in ``order``."""
    out = tuple(p[:, order[0]] for p in parts)
    for k in order[1:]:
        out = _merge(out, tuple(p[:, k] for p in parts))
    return out


def _tree_merged(parts):
    """Merge the partials (B, P) pairwise, P / 2 merges at a time: another
    order, and the fast one for the round model."""
    while parts[0].shape[1] > 1:
        P = parts[0].shape[1]
        if P % 2:
            empty = (np.full((len(parts[0]), 1), -np.inf, np.float32),
                     np.full((len(parts[0]), 1), _NO_COL), np.full((len(parts[0]), 1), _NEG32))
            parts = tuple(np.concatenate([p, e], axis=1) for p, e in zip(parts, empty))
            P += 1
        parts = _merge(tuple(p[:, :P // 2] for p in parts), tuple(p[:, P // 2:] for p in parts))
    return tuple(p[:, 0] for p in parts)


def _rows(kind, B, n, rng):
    if kind == "gauss":
        return rng.standard_normal((B, n)).astype(np.float32)
    if kind == "tied":
        return rng.integers(0, 3, (B, n)).astype(np.float32)
    if kind == "dups":
        v = rng.standard_normal((B, n // 2)).astype(np.float32)
        return np.repeat(v, 2, axis=1)[:, rng.permutation(n)]
    return np.broadcast_to(-np.arange(n, dtype=np.float32) * _F32(0.5), (B, n)).copy()  # rank 1


@pytest.mark.parametrize("acc", [1, 2, 4])
@pytest.mark.parametrize("kind", ["gauss", "tied", "dups", "rank1"])
def test_split_row_scan_equals_the_one_pass_scan(kind, acc):
    """The redesigned tiled kernel's scan: 1-32 column slices (w warps a
    row), with 1, 2 or 4 accumulators a lane (the kernel keeps one; more
    measured no faster, and the rule holds for any), merged in any order,
    give ``_one_pass_scan``'s bits, whatever w and the order of the
    merges."""
    rng = np.random.default_rng(acc)
    n = 256
    values = _rows(kind, 6, n, rng)
    ref = _one_pass_scan(values)
    for w in (1, 2, 4, 8, 16, 32):
        parts = _slice_partials(values, w, acc)
        P = parts[0].shape[1]
        for order in (np.arange(P), np.arange(P)[::-1], rng.permutation(P)):
            for got in (_merged(parts, order), _tree_merged(tuple(p[:, order] for p in parts))):
                for g, r in zip(got, ref):
                    np.testing.assert_array_equal(g, r)
        # the kernel's order: accumulators, then a butterfly over the lanes, then the warps
        per = tuple(p.reshape(6, w, 32, acc) for p in parts)
        lane = _merged(tuple(p.reshape(6 * w * 32, acc) for p in per), np.arange(acc))
        lane = tuple(p.reshape(6, w, 32) for p in lane)
        for o in (16, 8, 4, 2, 1):
            lane = _merge(lane, tuple(p[:, :, np.arange(32) ^ o] for p in lane))
        got = _merged(tuple(p[:, :, 0] for p in lane), np.arange(w))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


def _tiled_kernel_model(cost, num_phases=12, acc=1):
    """The redesigned tiled kernel (``csrc/auction_tiled.cu``) in numpy, its
    few-candidate round as it runs at n >= 2048: (perm, rounds, row scans).
    Each round's b candidates (the last round's bidders and evicted owners,
    or every row at a phase's start) set the warps a row, w = 32 / b
    rounded down to a power of two at b <= 32, else 1 (at most n / 4 here,
    where n < 128 would give a slice under one float4); the rows that own a
    column are skipped; a row's scan is its slices' partials merged
    (pairwise: any order gives the same bits, see
    test_split_row_scan_equals_the_one_pass_scan); each column goes to the
    highest bid, the smallest row on a tie (the packed atomicMax)."""
    n = cost.shape[0]
    benefit = -cost.astype(np.float32)
    eps, eps_final = _kernel_eps(benefit, num_phases)
    price = np.zeros(n, np.float32)
    owner, assign = np.full(n, -1), np.full(n, -1)
    cand = np.arange(n)
    rounds, scans, cap = 0, 0, 200 * n + 20000
    while (owner < 0).any() and rounds < cap:
        b = len(cand)
        w = 1 if b > 32 else min(1 << int(np.log2(32 // max(b, 1))), n // 4)
        rows = cand[assign[cand] < 0]
        parts = _slice_partials(benefit[rows] - price[None, :], w, acc)
        v1, j1, v2 = _tree_merged(parts)
        bid = (price[j1] + (v1 - v2)) + eps
        scans += len(rows)
        best = {}
        for r, j, bb in zip(rows, j1, bid):
            if bb > _NEG32 and (j not in best or (bb, -r) > (best[j][0], -best[j][1])):
                best[j] = (bb, r)
        evicted = []
        for j, (bb, r) in best.items():
            if owner[j] >= 0:
                assign[owner[j]] = -1
                evicted.append(owner[j])
            owner[j], assign[r], price[j] = r, j, bb
        cand = np.concatenate([rows, np.asarray(evicted, dtype=rows.dtype)])
        rounds += 1
        if (owner >= 0).all() and eps > eps_final:
            eps = _F32(eps / _F32(4.0))
            owner[:], assign[:] = -1, -1
            cand = np.arange(n)
    return np.where(assign >= 0, assign, n), rounds, scans


@pytest.mark.parametrize("kind", ["gauss", "ties", "dups", "rank1"])
@pytest.mark.parametrize("n", [64, 128, 256])
def test_tiled_kernel_model_equals_plain(n, kind):
    """The redesigned round in numpy gives the plain tiled version's
    permutation and round count, as ``test_kernel_model_equals_plain_and_jax``
    does for the dense kernel."""
    c = _cost(n, kind, seed=14)
    perm, rounds, scans = _tiled_kernel_model(c)
    ref, ref_rounds = tau.auction_assignment_tiled_reference(torch.from_numpy(c), tile=min(n, 256))
    got = tau._sanitize_perm(torch.from_numpy(perm), n)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert rounds == ref_rounds and scans >= n


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gauss", "ties", "dups"])
@pytest.mark.parametrize("n", [1024, 2048])
def test_tiled_kernel_matches_plain_on_cuda(n, kind):
    """The permutation and round count of the plain version. (On rank1,
    where every row bids in most rounds, the plain version takes 30k-60k
    rounds of about 1 ms on the card at these sizes; chip_smoke.py checks
    it at n = 256, 1024 and 2048.)"""
    if not torch.cuda.is_available():
        pytest.skip("the tiled auction kernel runs only on a CUDA device")
    c = torch.from_numpy(_cost(n, kind, seed=9)).cuda()
    before = tau.pallas_auction_assignment_tiled.launches
    perm = tas.solve_assignment(c)
    ref, rounds = tau.auction_assignment_tiled_reference(c)
    torch.cuda.synchronize()
    assert tau.pallas_auction_assignment_tiled.launches == before + 1
    assert int(tau.pallas_auction_assignment_tiled.last_rounds) == rounds
    assert int(tau.pallas_auction_assignment_tiled.last_row_scans) >= n
    assert torch.equal(perm, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gauss", "ties", "dups", "rank1"])
@pytest.mark.parametrize("n", [2, 64, 128, 200, 256, 512])
def test_kernel_matches_plain_on_cuda(n, kind):
    if not torch.cuda.is_available():
        pytest.skip("the auction kernel runs only on a CUDA device")
    c = torch.from_numpy(_cost(n, kind, seed=5)).cuda()
    before = tau.pallas_auction_assignment.launches
    perm = tau.pallas_auction_assignment(c)
    k_rounds = int(tau.pallas_auction_assignment.last_rounds)
    ref, rounds = tau.auction_assignment_onehot(c)
    torch.cuda.synchronize()
    assert tau.pallas_auction_assignment.launches == before + 1
    assert k_rounds == rounds and int(tau.pallas_auction_assignment.last_row_scans) >= n
    assert torch.equal(perm, ref) and perm.dtype == torch.int64
    again = tau.pallas_auction_assignment(c)  # a rerun: the same perm and rounds
    assert torch.equal(again, perm) and int(tau.pallas_auction_assignment.last_rounds) == rounds
