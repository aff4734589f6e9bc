"""The port's trajectory data (cfm_tpu_torch/data/trajectory.py) and
``OTPlanSampler.sample_trajectory`` against JAX, on shared numpy inputs.

The port is handed the numbers JAX draws from its keys (raw integer draws,
row indices, uniforms, normals, Gumbel noise): indices must then be equal,
and data transforms within 1e-6 absolute (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfm_tpu.coupling import OTPlanSampler as JOTPlanSampler
from cfm_tpu.data import trajectory as jtr
from cfm_tpu_torch.coupling import OTPlanSampler
from cfm_tpu_torch.data import trajectory as ttr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU work: the suite runs six
    workers on the machine's cores, and torch's OpenMP pool of one thread a
    core then waits on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _population(bs=64, T=5, D=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bs, T, D)) + np.arange(T)[None, :, None]).astype(np.float32)


@pytest.mark.parametrize("leaveout,training", [(-1, True), (2, True), (4, True), (2, False)])
def test_sample_segment_pairs_matches_jax(leaveout, training):
    X = _population()
    key = jax.random.PRNGKey(3)
    T = X.shape[1]
    held = training and 0 < leaveout < T
    t_draw = np.asarray(jax.random.randint(key, (X.shape[0],), 0, T - 2 if held else T - 1))
    ref = jtr.sample_segment_pairs(key, jnp.asarray(X), leaveout_timepoint=leaveout,
                                   training=training)
    out = ttr.sample_segment_pairs(None, _t(X), leaveout_timepoint=leaveout, training=training,
                                   t_draw=_t(t_draw))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    for a, b in zip(out[:2], ref[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if held and leaveout < T - 1:
        assert leaveout not in set(out[2].tolist())
    # Drawn from a generator: the same support.
    t_sel = ttr.sample_segment_pairs(torch.Generator().manual_seed(0), _t(X), leaveout, training)[2]
    assert set(t_sel.tolist()) <= set(range(T - 1)) - ({leaveout} if held else set())


def test_leaveout_adjusted_targets_match_jax():
    rng = np.random.default_rng(1)
    ut = rng.standard_normal((32, 3)).astype(np.float32)
    t = rng.uniform(size=32).astype(np.float32)
    t_sel = rng.integers(0, 4, 32)
    for leave in (-1, 1, 2, 4):
        ref = jtr.leaveout_adjusted_targets(jnp.asarray(ut), jnp.asarray(t), jnp.asarray(t_sel),
                                            leave)
        out = ttr.leaveout_adjusted_targets(_t(ut), _t(t), _t(t_sel), leave)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dim", [2, 5])
def test_tree_population_matches_jax_given_its_draws(dim):
    key = jax.random.PRNGKey(7)
    n, T = 50, 5
    k_branch, k_noise = jax.random.split(key)
    u = np.asarray(jax.random.uniform(k_branch, (n,)))
    noise = np.asarray(jax.random.normal(k_noise, (n, T, dim)))
    ref = np.asarray(jtr.tree_population(key, n, T=T, dim=dim))
    out = ttr.tree_population(None, n, T=T, dim=dim, branch_u=_t(u), noise=_t(noise)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    drawn = ttr.tree_population(torch.Generator().manual_seed(0), 2000, T=T, dim=dim)
    assert drawn.shape == (2000, T, dim)
    assert abs(float(drawn[:, -1, 1].abs().mean()) - 1.0) < 0.05  # branches end at +-1


def test_circle_and_cycle_populations_match_jax_given_their_draws():
    n, T = 40, 5
    for fn, tfn, scale in ((jtr.circle_population, ttr.circle_population, None),
                           (jtr.cycle_population, ttr.cycle_population, 0.05)):
        key = jax.random.PRNGKey(11)
        k0, k1 = jax.random.split(key)
        u = _t(jax.random.uniform(k0, (n,)))
        normals = _t(jax.random.normal(k1, (n, T, 2)))
        ref = np.asarray(fn(key, n, T=T))
        if scale is None:
            out = tfn(None, n, T=T, theta_u=u, noise=normals)
        else:
            out = tfn(None, n, T=T, noise=scale, theta_u=u, normals=normals)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    cyc = ttr.cycle_population(torch.Generator().manual_seed(1), 100, T=5, noise=0.0)
    torch.testing.assert_close(cyc[:, 0], cyc[:, 2], rtol=0, atol=1e-5)


def test_resample_to_trajectory_matches_jax_given_its_indices():
    rng = np.random.default_rng(2)
    marginals = [rng.standard_normal((n, 3)).astype(np.float32) for n in (20, 33, 17)]
    key = jax.random.PRNGKey(5)
    bs = 24
    idx = [_t(jax.random.randint(jax.random.fold_in(key, ti), (bs,), 0, m.shape[0]))
           for ti, m in enumerate(marginals)]
    ref = np.asarray(jtr.resample_to_trajectory(key, marginals, bs))
    out = ttr.resample_to_trajectory(None, marginals, bs, indices=idx)
    np.testing.assert_array_equal(out.numpy(), ref)
    drawn = ttr.resample_to_trajectory(torch.Generator().manual_seed(0), marginals, bs)
    assert drawn.shape == (bs, 3, 3)


def test_whiten_and_npz_loader_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    pcs = rng.standard_normal((90, 7)) * 3 + 1
    labels = np.repeat([0.0, 2.0, 1.0], 30)
    path = str(tmp_path / "toy.npz")
    np.savez(path, pcs=pcs, sample_labels=labels)
    ref_m, ref_t = jtr.load_npz_timeseries(path, max_dim=5)
    out_m, out_t = ttr.load_npz_timeseries(path, max_dim=5)
    np.testing.assert_array_equal(out_t, ref_t)
    for a, b in zip(out_m, ref_m):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ttr.whiten(out_m), jtr.whiten(ref_m)):
        for x, y in zip(a if isinstance(a, list) else [a], b if isinstance(b, list) else [b]):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)


@pytest.mark.parametrize("categorical", [False, True])
def test_h5ad_loaders_match_jax_on_a_written_file(tmp_path, categorical):
    import h5py

    rng = np.random.default_rng(4)
    T, n, d = 4, 12, 6
    emb = rng.standard_normal((T * n, d)).astype(np.float32)
    days = np.repeat(np.arange(T, dtype=np.float64), n)
    path = str(tmp_path / "toy.h5ad")
    with h5py.File(path, "w") as f:
        f.create_group("obsm").create_dataset("X_pca", data=emb)
        obs = f.create_group("obs")
        if categorical:
            g = obs.create_group("day")
            g.create_dataset("categories", data=np.arange(T, dtype=np.float64))
            g.create_dataset("codes", data=(days.astype(int)))
        else:
            obs.create_dataset("day", data=days)
        uns = f.create_group("uns")
        for t in range(T - 1):
            uns.create_dataset(f"pi_{t}_{t+1}", data=rng.uniform(size=(n, n)))
        for t in range(T - 2):
            uns.create_dataset(f"pi_{t+1}", data=rng.uniform(size=(n, n)))
    ref_m, ref_t = jtr.load_h5ad_timeseries(path, max_dim=4)
    out_m, out_t = ttr.load_h5ad_timeseries(path, max_dim=4)
    np.testing.assert_array_equal(out_t, ref_t)
    assert len(out_m) == T
    for a, b in zip(out_m, ref_m):
        np.testing.assert_array_equal(a, b)
    for leaveout in (False, True):
        ref_p, ref_s = jtr.load_h5ad_joint_plans(path, T, leaveout=leaveout)
        out_p, out_s = ttr.load_h5ad_joint_plans(path, T, leaveout=leaveout)
        for a, b in zip(out_p + (out_s or []), ref_p + (ref_s or [])):
            np.testing.assert_array_equal(a, b)
        assert (out_s is None) == (not leaveout)


def _jax_plan_draws(key, plan_sampler_segments, sizes, bs, T, leaveout):
    """The draws JAX's joint-plan sampler makes from ``key``."""
    k_t, k_i, k_u = jax.random.split(key, 3)
    held = 0 < leaveout < T
    t_draw = _t(jax.random.randint(k_t, (bs,), 0, T - 2 if held else T - 1))
    u = _t(jax.random.uniform(k_u, (bs,)))
    rows = {t: _t(jax.random.randint(jax.random.fold_in(k_i, t), (bs,), 0, sizes[t]))
            for t in plan_sampler_segments}
    return t_draw, rows, u


@pytest.mark.parametrize("leaveout", [-1, 2, 3])
def test_joint_plan_sampler_matches_jax_given_its_draws(leaveout):
    """Dense random plans over jagged marginals (unnormalised rows), with
    the middle and the last timepoint held out."""
    rng = np.random.default_rng(5)
    T = 4
    sizes = [9, 13, 11, 7]
    marginals = [rng.standard_normal((n, 2)).astype(np.float32) for n in sizes]
    plans = [rng.uniform(size=(sizes[t], sizes[t + 1])) ** 3 for t in range(T - 1)]
    straddle = [rng.uniform(size=(sizes[t], sizes[t + 2])) for t in range(T - 2)]
    kw = dict(leaveout_timepoint=leaveout, straddle_plans=straddle)
    ref_sample = jtr.make_joint_plan_sampler(marginals, plans, **kw)
    sampler = ttr.make_joint_plan_sampler(marginals, [_t(p) for p in plans], **kw)
    bs = 256
    key = jax.random.PRNGKey(9)
    t_draw, rows, u = _jax_plan_draws(key, sampler.segments, sizes, bs, T, leaveout)
    ref = jax.jit(ref_sample, static_argnums=1)(key, bs)
    out = sampler(None, bs, t_draw=t_draw, rows=rows, u=u)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if leaveout == 2:
        assert 2 not in set(out[2].tolist()) and set(sampler.segments) == {0, 1}
    if leaveout == 3:
        assert set(sampler.segments) == {0, 1}
    x0, x1, t_sel = sampler(torch.Generator().manual_seed(0), 64)
    assert x0.shape == x1.shape == (64, 2) and t_sel.shape == (64,)


def test_joint_plan_sampler_rejects_bad_plans():
    m = [np.zeros((4, 2), np.float32), np.zeros((5, 2), np.float32), np.zeros((4, 2), np.float32)]
    with pytest.raises(ValueError, match="expected"):
        ttr.make_joint_plan_sampler(m, [np.ones((4, 4)), np.ones((5, 4))])
    with pytest.raises(ValueError, match="straddle_plans"):
        ttr.make_joint_plan_sampler(m, [np.ones((4, 5)), np.ones((5, 4))], leaveout_timepoint=1)


@pytest.mark.parametrize("bs,T", [(32, 5), (64, 3)])
def test_sample_trajectory_equals_jax_on_tie_free_exact_plans(bs, T):
    """Exact plans of tie-free clouds are permutations, so each row is one-hot
    and the chained trajectories must be equal; the port is also handed
    JAX's Gumbel noise."""
    X = _population(bs=bs, T=T, D=2, seed=bs)
    key = jax.random.PRNGKey(13)
    keys = jax.random.split(key, T - 1)
    gumbel = [_t(jax.vmap(lambda k: jax.random.gumbel(k, (bs,)))(jax.random.split(keys[t], bs)))
              for t in range(T - 1)]
    ref = np.asarray(jax.jit(JOTPlanSampler(method="exact").sample_trajectory)(key, jnp.asarray(X)))
    sampler = OTPlanSampler(method="exact")
    out = sampler.sample_trajectory(None, _t(X), gumbel=gumbel)
    np.testing.assert_array_equal(out.numpy(), ref)
    drawn = sampler.sample_trajectory(torch.Generator().manual_seed(0), _t(X))
    np.testing.assert_array_equal(drawn.numpy(), ref)
    # Each timepoint's slice is a re-ordering of the population's.
    for t in range(T):
        np.testing.assert_array_equal(np.sort(out[:, t].numpy(), axis=0), np.sort(X[:, t], axis=0))
