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
    ref, rounds = tau.auction_assignment_onehot(c)
    torch.cuda.synchronize()
    assert tau.pallas_auction_assignment.launches == before + 1
    assert int(tau.pallas_auction_assignment.last_rounds) == rounds
    assert torch.equal(perm, ref)
