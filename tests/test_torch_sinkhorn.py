"""The port's entropic solvers (cfm_tpu_torch/ops/sinkhorn.py and
ops/flash_sinkhorn.py) against the JAX package, on the CPU, on shared numpy
inputs.

- The seven solvers of ``ops/sinkhorn.py`` at n = 48, m = 40, f32: plans
  within rtol 1e-4, atol 1e-7 (``tests/test_coupling.py``'s tolerance for
  the flash-vs-dense plans), potentials within rtol 1e-4, atol 1e-5;
  ``emd_annealed``, whose plan at its final epsilon moves by 4.8e-6 in JAX
  itself when the cost moves by one ulp, within 1e-5.
- ``flash_sinkhorn_reference`` (the plain version of kernel #7) against the
  TPU kernel ``_flash_kernel`` run in interpret mode (``INTERPRET`` set and
  restored), at (64, 48) and at a multi-tile (1024, 640): f and g within
  rtol 1e-4, atol 1e-5, the same stopping iteration.
- ``sinkhorn_from_points`` on the CPU against JAX's materialised-cost twin,
  and the three chunked consumers given JAX's potentials (and, for the
  sampler, the Gumbel noise JAX draws from its per-chunk keys): equal
  indices, the cost within 1e-5 and the row error within 1e-4 relative
  (2e-6 absolute for a converged solve, whose error is f32 noise).

- ``_fused_model``, the Hopper kernel's iteration in plain torch (an f
  pass, then a g pass and one row LSE that gives both the row error and the
  next f; no error pass at the cap; the last f kept on a stop), against
  ``flash_sinkhorn_reference`` (the same iteration count, potentials within
  1e-5 relative) and against ``_flash_kernel`` in interpret mode.

The ``cuda``-marked tests hold the kernel against its plain version on the
card (f and g within 1e-4 relative + 1e-5 reg absolute at a fixed count;
the stopping iteration within 1; a rerun bit for bit), at the path's shape
and at shapes that take the kernel's other branches (2-D clouds tiled
through shared memory, d = 32, coordinates read from global memory), and
skip without one; the chip machine has
no flax, so this file imports the JAX package only inside the CPU tests.
"""

import importlib

import numpy as np
import pytest
import torch

from cfm_tpu_torch.ops import flash_sinkhorn as tfs
tsk = importlib.import_module("cfm_tpu_torch.ops.sinkhorn")


def _clouds(n, m, d=2, seed=0, shift=0.7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            (rng.standard_normal((m, d)) * 1.3 + shift).astype(np.float32))


def _cost(x, y):
    return ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1).astype(np.float32)


def _weights(k, seed):
    w = np.random.default_rng(seed).uniform(0.5, 1.5, k).astype(np.float32)
    return (w / w.sum()).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


_SOLVERS = {
    "sinkhorn": dict(reg=0.5),
    "sinkhorn2": dict(reg=0.5),
    "sinkhorn_unbalanced": dict(reg=0.5, reg_m=1.0),
    "sinkhorn_unbalanced_pair": dict(reg=0.5, reg_m=(1.0, float("inf"))),
    "partial_wasserstein": dict(reg=0.5, mass=0.6),
    "emd_annealed": dict(),
}


@pytest.mark.parametrize("name", sorted(_SOLVERS))
@pytest.mark.parametrize("weighted", [False, True])
def test_solvers_match_jax(name, weighted):
    import jax.numpy as jnp

    jsk = importlib.import_module("cfm_tpu.ops.sinkhorn")

    n, m = 48, 40
    x, y = _clouds(n, m, seed=1)
    M = _cost(x, y)
    a = _weights(n, 2) if weighted else np.full(n, 1 / n, np.float32)
    b = _weights(m, 3) if weighted else np.full(m, 1 / m, np.float32)
    kw = _SOLVERS[name]
    fn = name[:-5] if name.endswith("_pair") else name
    ref = np.asarray(getattr(jsk, fn)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(M), **kw))
    out = getattr(tsk, fn)(_t(a), _t(b), _t(M), **kw)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    if fn != "emd_annealed":
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-7)
        return
    # emd_annealed ends at epsilon = 1e-4 of the cost range, where a plan is
    # as sensitive as f32 allows: JAX's own plan moves by 4.8e-6 when M moves
    # by one ulp. Its entries are held to 1e-5, its cost to 1e-5 relative and
    # its marginals (exact by the rounding) to 1e-6.
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(float((out * _t(M)).sum()), float((ref * M).sum()), rtol=1e-5)
    np.testing.assert_allclose(out.sum(1).numpy(), a, atol=1e-6)
    np.testing.assert_allclose(out.sum(0).numpy(), b * a.sum() / b.sum(), atol=1e-6)


def test_sinkhorn_potentials_and_round_to_feasible_match_jax():
    import jax.numpy as jnp

    jsk = importlib.import_module("cfm_tpu.ops.sinkhorn")

    n, m = 48, 40
    x, y = _clouds(n, m, seed=4)
    M = _cost(x, y)
    la, lb = np.log(_weights(n, 5)), np.log(np.full(m, 1 / m, np.float32))
    for reg, iters in ((0.5, 1000), (0.05, 37)):
        fj, gj = jsk.sinkhorn_potentials(jnp.asarray(la), jnp.asarray(lb), jnp.asarray(M), reg,
                                         num_iters=iters)
        f, g = tsk.sinkhorn_potentials(_t(la), _t(lb), _t(M), reg, num_iters=iters)
        np.testing.assert_allclose(f.numpy(), np.asarray(fj), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-5)
    plan = np.random.default_rng(6).uniform(0, 2.0 / (n * m), (n, m)).astype(np.float32)
    a, b = _weights(n, 7), _weights(m, 8)
    ref = np.asarray(jsk.round_to_feasible(jnp.asarray(plan), jnp.asarray(a), jnp.asarray(b)))
    out = tsk.round_to_feasible(_t(plan), _t(a), _t(b)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(out.sum(1), a, rtol=1e-4)


def _flash_jax(x, y, la, lb, reg, iters, tol):
    """JAX's Pallas kernel #7 in interpret mode on centred clouds."""
    import jax.numpy as jnp

    jfs = importlib.import_module("cfm_tpu.ops.flash_sinkhorn")

    old = jfs.INTERPRET
    jfs.INTERPRET = True
    try:
        f, g = jfs._flash_sinkhorn_pallas(jnp.asarray(x), jnp.asarray(y), jnp.asarray(la),
                                          jnp.asarray(lb), reg, iters, tol)
    finally:
        jfs.INTERPRET = old
    return np.asarray(f), np.asarray(g)


@pytest.mark.parametrize("n,m,d,reg,iters,tol", [
    (64, 48, 4, 0.3, 1000, 1e-6),       # one tile, run to convergence
    (1024, 640, 2, 0.5, 10, 0.0),       # tiles (512, 128): 2 x 5, a fixed count
])
def test_plain_flash_matches_the_tpu_kernel_in_interpret_mode(n, m, d, reg, iters, tol):
    x, y = _clouds(n, m, d, seed=n)
    xc, yc = (v.numpy() for v in tfs._center(_t(x), _t(y)))
    la = np.log(_weights(n, 9))
    lb = np.full(m, np.log(np.float32(1 / m)), np.float32)
    fj, gj = _flash_jax(xc, yc, la, lb, reg, iters, tol)
    f, g, it = tfs.flash_sinkhorn_reference(_t(xc), _t(yc), _t(la), _t(lb), reg, iters, tol)
    np.testing.assert_allclose(f.numpy(), fj, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), gj, rtol=1e-4, atol=1e-5)
    # JAX keeps its count inside the kernel: the port's must stop where the
    # row error first meets tol, checked every iteration.
    assert (it == iters) if tol == 0.0 else (0 < it < iters)
    fw, gw = tfs.flash_sinkhorn(_t(xc), _t(yc), _t(la), _t(lb), reg, iters, tol)
    assert torch.equal(fw, f) and torch.equal(gw, g) and int(tfs.flash_sinkhorn.last_iters) == it


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the plain versions' many small ops: under the
    suite's parallel workers, OpenMP's fork-join barriers otherwise stall
    each op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fused_model(x, y, loga, logb, reg, num_iters, tol):
    """The kernel's iteration on the plain version's tiles: (f, g,
    iterations, passes). One f pass from g = 0; then per iteration a g pass
    and, but at the cap, one row LSE that gives both the row error against f
    and the next f; on a stop f stays the last f pass's."""
    t = tfs._Tiled(x, y, reg)
    loga, logb = loga.float(), logb.float()
    rows = lambda g: torch.cat([t.row_lse(g, i0) for i0 in range(0, t.n, t.ti)])
    cols = lambda f: torch.cat([t.col_lse(f, j0) for j0 in range(0, t.m, t.tj)])
    f, g = torch.zeros(t.n), torch.zeros(t.m)
    if num_iters <= 0:
        return f, g, 0, 0
    f, passes, it = t.reg * (loga - rows(g)), 1, 0
    while True:
        g, passes, it = t.reg * (logb - cols(f)), passes + 1, it + 1
        if it >= num_iters:
            break
        lse, passes = rows(g), passes + 1
        err = torch.sum(torch.abs(torch.exp(lse + f / t.reg) - torch.exp(loga)))
        if not float(err) > tol:
            break
        f = t.reg * (loga - lse)
    return f, g, it, passes


_FUSED_CASES = {
    "2d_sf2m-like": (256, 256, 2, 2.0, 1000, 1e-6),
    "n != m, d = 3": (96, 160, 3, 0.5, 1000, 1e-6),
    "the cap": (256, 256, 2, 2.0, 5, 0.0),
    "one iteration": (96, 160, 3, 0.5, 1000, 10.0),
}


@pytest.mark.parametrize("case", sorted(_FUSED_CASES))
def test_fused_iteration_matches_plain_and_the_tpu_kernel(case):
    n, m, d, reg, iters, tol = _FUSED_CASES[case]
    x, y = _clouds(n, m, d, seed=n + m)
    xc, yc = tfs._center(_t(x), _t(y))
    la = torch.from_numpy(np.log(_weights(n, 17)))
    lb = torch.full((m,), 1.0 / m).log()
    f, g, it, passes = _fused_model(xc, yc, la, lb, reg, iters, tol)
    fr, gr, it_ref = tfs.flash_sinkhorn_reference(xc, yc, la, lb, reg, iters, tol)
    assert it == it_ref
    # Two passes an iteration: no error pass at the cap, one more on a stop.
    assert passes == 2 * it + (0 if it == iters else 1)
    if case == "the cap":
        assert it == 5
    if case == "one iteration":
        assert it == 1
    for out, ref in ((f, fr), (g, gr)):
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))
    fj, gj = _flash_jax(xc.numpy(), yc.numpy(), la.numpy(), lb.numpy(), reg, iters, tol)
    for out, ref in ((f, fj), (g, gj)):
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("tol", [1e-2, 1e-4, 1e-6])
def test_fused_model_stops_where_the_plain_error_first_meets_tol(tol):
    """The row error the fused pass measures is the plain version's
    statistic for the same (f, g): the model stops at the first iteration
    whose potentials meet tol."""
    n, m = 64, 80
    x, y = _clouds(n, m, 2, seed=18)
    xc, yc = tfs._center(_t(x), _t(y))
    la, lb = torch.full((n,), 1.0 / n).log(), torch.full((m,), 1.0 / m).log()
    f, g, it, _ = _fused_model(xc, yc, la, lb, 0.3, 1000, tol)
    assert 1 < it < 1000
    assert float(tfs.flash_row_error(xc, yc, f, g, la, 0.3)) <= tol
    fp, gp, _, _ = _fused_model(xc, yc, la, lb, 0.3, it - 1, 0.0)
    assert float(tfs.flash_row_error(xc, yc, fp, gp, la, 0.3)) > tol


def test_fused_model_with_no_iterations_returns_zeros():
    x, y = _clouds(8, 8, 2, seed=19)
    la = torch.full((8,), 1.0 / 8).log()
    f, g, it, passes = _fused_model(_t(x), _t(y), la, la, 1.0, 0, 1e-6)
    fr, gr, it_ref = tfs.flash_sinkhorn_reference(_t(x), _t(y), la, la, 1.0, 0, 1e-6)
    assert it == it_ref == 0 and passes == 0
    assert torch.equal(f, fr) and torch.equal(g, gr) and not f.any() and not g.any()


def test_sinkhorn_from_points_on_the_cpu_is_the_dense_twin():
    import jax.numpy as jnp

    jfs = importlib.import_module("cfm_tpu.ops.flash_sinkhorn")

    n, m = 96, 80
    x, y = _clouds(n, m, 3, seed=11, shift=4.0)
    f, g = tfs.sinkhorn_from_points(_t(x), _t(y), 0.4)
    fj, gj = jfs.sinkhorn_from_points(jnp.asarray(x), jnp.asarray(y), 0.4)
    np.testing.assert_allclose(f.numpy(), np.asarray(fj), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-5)
    a = _weights(n, 12)
    f, g = tfs.sinkhorn_from_points(_t(x), _t(y), 0.4, a=_t(a), num_iters=20)
    fj, gj = jfs.sinkhorn_from_points(jnp.asarray(x), jnp.asarray(y), 0.4, a=jnp.asarray(a),
                                      num_iters=20)
    np.testing.assert_allclose(f.numpy(), np.asarray(fj), rtol=1e-4, atol=1e-5)


def test_consumers_match_jax_given_its_potentials_and_gumbels():
    import jax
    import jax.numpy as jnp

    jfs = importlib.import_module("cfm_tpu.ops.flash_sinkhorn")

    n, m, chunk, reg = 96, 80, 32, 0.3
    x, y = _clouds(n, m, 2, seed=13, shift=2.0)
    X, Y = jnp.asarray(x), jnp.asarray(y)
    f, g = jfs.sinkhorn_from_points(X, Y, reg)
    key = jax.random.PRNGKey(14)
    idx = np.asarray(jfs.plan_sample_from_potentials(key, X, Y, f, g, reg, chunk=chunk))
    # JAX draws each chunk's Gumbel noise from its own key.
    gum = np.concatenate([np.asarray(jax.random.gumbel(k, (chunk, m)))
                          for k in jax.random.split(key, n // chunk)])
    tf, tg = _t(np.asarray(f)), _t(np.asarray(g))
    out = tfs.plan_sample_from_potentials(None, _t(x), _t(y), tf, tg, reg, chunk=chunk,
                                          gumbel=_t(gum))
    np.testing.assert_array_equal(out.numpy(), idx)
    assert len(set(idx.tolist())) > 1
    # The certificate of a converged solve is f32 noise (about 5e-6), held
    # absolutely; that of a solve cut at 5 iterations relatively.
    f5, g5 = jfs.sinkhorn_from_points(X, Y, reg, num_iters=5)
    for (fj, gj), atol in (((f, g), 2e-6), ((f5, g5), 0.0)):
        for a in (None, _weights(n, 15)):
            ref = jfs.row_marginal_error_from_potentials(X, Y, fj, gj, reg, chunk=chunk,
                                                         a=None if a is None else jnp.asarray(a))
            err = tfs.row_marginal_error_from_potentials(
                _t(x), _t(y), _t(np.asarray(fj)), _t(np.asarray(gj)), reg, chunk=chunk,
                a=None if a is None else _t(a))
            np.testing.assert_allclose(float(err), float(ref), rtol=1e-4, atol=atol)
            assert atol or float(ref) > 1e-2
    ref = jfs.transport_cost_from_potentials(X, Y, f, g, reg, chunk=chunk)
    cost = tfs.transport_cost_from_potentials(_t(x), _t(y), tf, tg, reg, chunk=chunk)
    np.testing.assert_allclose(float(cost), float(ref), rtol=1e-5)
    drawn = tfs.plan_sample_from_potentials(torch.Generator().manual_seed(0), _t(x), _t(y),
                                            tf, tg, reg, chunk=chunk)
    assert drawn.dtype == torch.int64 and tuple(drawn.shape) == (n,)


def test_routing_gate_matches_jax():
    """The kernel route takes JAX's conditions with "TPU backend" replaced by
    "CUDA tensor": the same (n, m, d) pass, and a CPU tensor never does."""
    jfs = importlib.import_module("cfm_tpu.ops.flash_sinkhorn")

    shapes = [(2048, 2048, 2), (1000, 1536, 2), (2048, 2048, 512), (2048, 2048, 1024),
              (100, 130, 2), (520, 1000, 3), (4096, 4096, 3072), (8, 8, 2)]
    old = jfs.INTERPRET
    jfs.INTERPRET = True  # JAX's gate then checks the tiles and budget alone
    try:
        for n, m, d in shapes:
            assert tfs.flash_kernel_supported(n, m, d, "cuda") == jfs.flash_kernel_supported(
                n, m, d), (n, m, d)
            assert tfs._pallas_tiles(n, m) == jfs._pallas_tiles(n, m)
            assert not tfs.flash_kernel_supported(n, m, d, "cpu")
    finally:
        jfs.INTERPRET = old
    assert tfs._pick_tile(2048, 1024) == 1024 and tfs._pick_tile(1000, 1024) == 1000


def test_wrapper_refuses_bad_inputs():
    x = torch.zeros(4, 2)
    la = torch.full((4,), 0.25).log()
    with pytest.raises(ValueError, match="x \\(n, d\\) and y \\(m, d\\)"):
        tfs.flash_sinkhorn(x, torch.zeros(4, 3), la, la, 1.0)
    with pytest.raises(ValueError, match="wrong shape"):
        tfs.flash_sinkhorn(x, x, la[:3], la, 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        tfs.flash_sinkhorn(x.to("meta"), x.to("meta"), la.to("meta"), la.to("meta"), 1.0)


def _card_clouds(n, m, d, seed):
    """Gaussian clouds, scaled by sqrt(32 / d) beyond d = 32 so that the
    costs keep the d = 32 clouds' range, where f32 resolves the absolute
    1e-5 reg of the tolerance (at costs near 9,000 an ulp is 1e-3)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    s = min(1.0, (32 / d) ** 0.5)
    x = torch.randn(n, d, device="cuda", generator=g) * s
    y = (torch.randn(m, d, device="cuda", generator=g) * 1.3 + 0.5) * s
    return tfs._center(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d,reg,weighted", [
    (2048, 2048, 2, 2.0, False),   # the 2d_sf2m path's shape and reg
    (1000, 1536, 2, 0.5, False),   # unequal sizes, tails
    (512, 512, 32, 4.0, False),    # d = 32: the generic dimension loop
    (640, 384, 2, 1.0, True),      # a non-uniform loga
    (512, 512, 2, 0.05, False),    # a small reg
    (4096, 4096, 2, 2.0, False),   # d = 2 beyond the clouds' room in shared memory: tiled
    (128, 128, 3072, 4.0, False),  # CIFAR-10's width, scaled: coordinates in global memory
])
def test_kernel_matches_plain_on_cuda(n, m, d, reg, weighted):
    if not torch.cuda.is_available():
        pytest.skip("the flash Sinkhorn kernel runs only on a CUDA device")
    x, y = _card_clouds(n, m, d, seed=n + d)
    la = (torch.from_numpy(np.log(_weights(n, 16))) if weighted
          else torch.full((n,), 1.0 / n).log()).cuda()
    lb = torch.full((m,), 1.0 / m, device="cuda").log()
    before = tfs.flash_sinkhorn.launches
    f, g = tfs.flash_sinkhorn(x, y, la, lb, reg, 50, 0.0)
    torch.cuda.synchronize()
    assert tfs.flash_sinkhorn.launches == before + 1
    assert int(tfs.flash_sinkhorn.last_iters.item()) == 50
    fr, gr, it = tfs.flash_sinkhorn_reference(x, y, la, lb, reg, 50, 0.0)
    assert it == 50
    for out, ref in ((f, fr), (g, gr)):
        assert ((out - ref).abs() <= 1e-4 * ref.abs() + 1e-5 * reg).all()
    f, g = tfs.flash_sinkhorn(x, y, la, lb, reg, 2000, 1e-6)
    k_it = int(tfs.flash_sinkhorn.last_iters.item())
    _, _, p_it = tfs.flash_sinkhorn_reference(x, y, la, lb, reg, 2000, 1e-6)
    assert abs(k_it - p_it) <= 1, (k_it, p_it)
    f2, g2 = tfs.flash_sinkhorn(x, y, la, lb, reg, 2000, 1e-6)
    assert int(tfs.flash_sinkhorn.last_iters.item()) == k_it
    assert torch.equal(f, f2) and torch.equal(g, g2)  # a fixed-order error sum, bit for bit
