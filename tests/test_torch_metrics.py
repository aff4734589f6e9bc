"""The port's distribution metrics (cfm_tpu_torch/eval/metrics.py), growth
interpolation and EMD (eval/growth.py) and graph metrics (eval/graphs.py)
against JAX and scikit-learn, on shared numpy inputs.

Metrics within 1e-5 relative. The MMDs are differences of kernel means
that cancel (the RBF mixture's means are near 2.5 where the MMD is near
0.1), so float32 sums put JAX and the port alike about 1e-4 relative from a
float64 evaluation; they are held within 1e-5 of the magnitude of their
terms (``_mmd_f64``), to JAX and to float64 both.
Interpolations given JAX's uniforms within 1e-6 absolute; the graph
metrics, numpy on both sides, equal (AUC and AP to 1e-12 of scikit-learn's,
ties included).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfm_tpu.eval import graphs as jgr
from cfm_tpu.eval import growth as jgw
from cfm_tpu.eval import metrics as jme
from cfm_tpu_torch.eval import graphs as tgr
from cfm_tpu_torch.eval import growth as tgw
from cfm_tpu_torch.eval import metrics as tme


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU work: the suite runs six
    workers on the machine's cores, and torch's OpenMP pool of one thread a
    core then waits on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _clouds(n, m=None, d=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            (rng.standard_normal((m or n, d)) * 1.3 + 0.5).astype(np.float32))


def _mmd_f64(name, x, y, biased=True):
    """(value, scale) of an MMD in float64: scale sums the magnitudes of the
    terms whose difference the MMD is."""
    x, y = x.astype(np.float64), y.astype(np.float64)
    if name == "Linear_MMD":
        p = np.sum((x - y)[:-1] * (x - y)[1:], axis=1)
        return p.mean(), np.abs(p).mean()
    if name == "Poly_MMD":
        k = [np.mean((np.sum(a[:-1] * b[1:], axis=1) + 2.0) ** 2)
             for a, b in ((x, x), (y, y), (x, y), (y, x))]
        return k[0] + k[1] - k[2] - k[3], sum(k)
    d2 = [np.sum((a[:, None] - b[None]) ** 2, -1) for a, b in ((x, x), (y, y), (x, y))]
    kxx, kyy, kxy = (sum(np.exp(-d / (2 * s ** 2)) for s in (0.01, 0.1, 1, 10, 100)) for d in d2)
    m, n = len(x), len(y)
    if biased:
        return kxx.mean() + kyy.mean() - 2 * kxy.mean(), kxx.mean() + kyy.mean() + 2 * kxy.mean()
    off_x, off_y = kxx.sum() - np.trace(kxx), kyy.sum() - np.trace(kyy)
    terms = (off_x / (m * (m - 1)), off_y / (n * (n - 1)), 2 * kxy.mean())
    return terms[0] + terms[1] - terms[2], sum(terms)


@pytest.mark.parametrize("name", ["Linear_MMD", "Poly_MMD", "RBF_MMD", "unbiased"])
def test_mmds_match_jax(name):
    x, y = _clouds(48, seed=1)
    fn = {"Linear_MMD": "linear_mmd2", "Poly_MMD": "poly_mmd2"}.get(name, "mix_rbf_mmd2")
    kw = dict(biased=False) if name == "unbiased" else {}
    ref = float(getattr(jme, fn)(jnp.asarray(x), jnp.asarray(y), **kw))
    out = float(getattr(tme, fn)(_t(x), _t(y), **kw))
    exact, scale = _mmd_f64("RBF_MMD" if name == "unbiased" else name, x, y, **kw)
    assert abs(out - ref) <= RTOL * scale and abs(out - exact) <= RTOL * scale, (out, ref, exact)


def test_median_is_jnp_median_on_even_counts():
    """``jnp.median`` averages the two middle values of an even count;
    ``torch.median`` would return the lower one."""
    x, _ = _clouds(1000, seed=2)
    ref = np.asarray(jnp.median(jnp.asarray(x), axis=0))
    out = tme._median(_t(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    assert not np.allclose(torch.median(_t(x), dim=0).values.numpy(), ref, rtol=1e-6, atol=0)
    assert tme.NAMES == jme.NAMES


def test_compute_distances_matches_jax():
    a, b = _clouds(1, d=5, seed=3)
    ref = jme.compute_distances(jnp.asarray(a[0]), jnp.asarray(b[0]))
    out = tme.compute_distances(_t(a[0]), _t(b[0]))
    np.testing.assert_allclose(out, ref, rtol=RTOL)


@pytest.mark.parametrize("kind", ["arrays", "lists", "jagged", "unequal", "one_timepoint"])
def test_compute_distribution_distances_matches_jax(kind):
    """(B, T, D) tensors with the MMDs; lists (no MMDs); jagged lists and
    unequal tensors, whose unequal timepoints take the entropic W1/W2."""
    rng = np.random.default_rng(4)
    T = 1 if kind == "one_timepoint" else 3
    pred = rng.standard_normal((64, T, 2)).astype(np.float32)
    true = (rng.standard_normal((64, T, 2)) + 0.3).astype(np.float32)
    if kind == "arrays" or kind == "one_timepoint":
        jp, jt, tp, tt = jnp.asarray(pred), jnp.asarray(true), _t(pred), _t(true)
    elif kind == "unequal":
        jp, jt, tp, tt = jnp.asarray(pred), jnp.asarray(true[:48]), _t(pred), _t(true[:48])
    else:
        sizes = [64, 40, 64] if kind == "jagged" else [64] * 3
        tl = [true[:n, i] for i, n in enumerate(sizes)]
        jp, jt = [jnp.asarray(pred[:, i]) for i in range(T)], [jnp.asarray(a) for a in tl]
        tp, tt = [_t(pred[:, i]) for i in range(T)], [_t(a) for a in tl]
    ref_names, ref_vals = jme.compute_distribution_distances(jp, jt)
    names, vals = tme.compute_distribution_distances(tp, tt)
    assert names == ref_names
    atol = np.full(len(names), 1e-7)
    for i, n in enumerate(names):  # the MMDs at 1e-5 of their terms' magnitude
        if n.endswith("MMD"):
            ts = [int(n[1:n.index("/")]) - 1] if "/" in n else range(T)
            atol[i] = RTOL * np.mean([_mmd_f64(n.split("/")[-1], pred[:, k], true[:, k])[1]
                                      for k in ts])
    vals, ref_vals = np.array(vals), np.array(ref_vals)
    bad = np.abs(vals - ref_vals) > RTOL * np.abs(ref_vals) + atol
    assert not bad.any(), [(n, v, r) for n, v, r, b in zip(names, vals, ref_vals, bad) if b]
    assert any("MMD" in n for n in names) == (kind in ("arrays", "one_timepoint"))


@pytest.mark.parametrize("metric,weighted", [("sqeuclidean", False), ("euclidean", False),
                                             ("sqeuclidean", True)])
def test_earth_mover_distance_matches_jax(metric, weighted):
    p, q = _clouds(40, 30, d=2, seed=5)
    kw = dict(metric=metric, reg=0.05)
    if weighted:
        rng = np.random.default_rng(6)
        w1, w2 = rng.uniform(0.5, 2, 40).astype(np.float32), rng.uniform(0.5, 2, 30).astype(
            np.float32)
        ref = float(jgw.earth_mover_distance(jnp.asarray(p), jnp.asarray(q), jnp.asarray(w1),
                                             jnp.asarray(w2), **kw))
        out = float(tgw.earth_mover_distance(_t(p), _t(q), _t(w1), _t(w2), **kw))
    else:
        ref = float(jgw.earth_mover_distance(jnp.asarray(p), jnp.asarray(q), **kw))
        out = float(tgw.earth_mover_distance(_t(p), _t(q), **kw))
    assert out == pytest.approx(ref, rel=RTOL)


def test_interpolations_match_jax_given_its_uniforms():
    rng = np.random.default_rng(7)
    p0, p1 = rng.standard_normal((12, 2)).astype(np.float32), rng.standard_normal(
        (9, 2)).astype(np.float32)
    tmap = rng.uniform(size=(12, 9)).astype(np.float32) ** 2
    key = jax.random.PRNGKey(1)
    ref = jax.jit(jgw.interpolate_with_ot, static_argnums=(4, 5))(
        key, jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(tmap), 0.3, 50)
    out = tgw.interpolate_with_ot(None, _t(p0), _t(p1), _t(tmap), 0.3, 50,
                                  u=_t(jax.random.uniform(key, (50,))))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    p1b = rng.standard_normal((9, 2)).astype(np.float32)
    ref = jax.jit(jgw.interpolate_per_point_with_ot, static_argnums=4)(
        key, jnp.asarray(p0), jnp.asarray(p1b), jnp.asarray(tmap), 0.6)
    out = tgw.interpolate_per_point_with_ot(None, _t(p0), _t(p1b), _t(tmap), 0.6,
                                            u=_t(jax.random.uniform(key, (12, 1))))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    g = torch.Generator().manual_seed(0)
    assert tgw.interpolate_with_ot(g, _t(p0), _t(p1), _t(tmap), 0.3, 50).shape == (50, 2)
    with pytest.raises(ValueError, match="p0 has 9 points"):
        tgw.interpolate_per_point_with_ot(g, _t(p1b), _t(p1b), _t(tmap), 0.5)
    with pytest.raises(ValueError, match="p1 has 12 points"):
        tgw.interpolate_per_point_with_ot(g, _t(p0), _t(p0), _t(tmap), 0.5)


def _scores_with_ties(rng, shape):
    return np.round(rng.uniform(size=shape) * 4) / 4  # five distinct values: many ties


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_roc_auc_and_average_precision_equal_sklearn_with_ties(seed):
    from sklearn.metrics import average_precision_score, roc_auc_score

    rng = np.random.default_rng(seed)
    y = (rng.uniform(size=200) < 0.3).astype(float)
    for s in (_scores_with_ties(rng, 200), rng.uniform(size=200), y * 0.5 + 0.25):
        assert tgr.roc_auc(y, s) == pytest.approx(roc_auc_score(y, s), rel=0, abs=1e-12)
        assert tgr.average_precision(y, s) == pytest.approx(average_precision_score(y, s),
                                                            rel=0, abs=1e-12)


def test_compare_graphs_matches_jax_with_ties():
    rng = np.random.default_rng(8)
    true = (rng.uniform(size=(10, 10)) < 0.25).astype(int)
    true[7, 0] = -1  # a deidentified row, clamped to 0
    for est in (_scores_with_ties(rng, (10, 10)), (rng.uniform(size=(10, 10)) > 0.6) * 1.0):
        ref, out = jgr.compare_graphs(true, est), tgr.compare_graphs(true, est)
        assert set(out) == set(ref)
        for k in ref:
            assert out[k] == pytest.approx(ref[k], rel=0, abs=1e-12), k
    assert "auc" not in tgr.compare_graphs(np.zeros((3, 3)), rng.uniform(size=(3, 3)))


def test_the_other_graph_metrics_match_jax():
    true = np.array([[0, 1, 1, 0], [0, 0, 1, 0], [0, 0, 0, 0], [-1, 0, 0, 0]])
    rng = np.random.default_rng(9)
    graphs = [(rng.uniform(size=(4, 4)) < 0.4).astype(float) for _ in range(30)]
    graphs += [np.array([[0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 0], [0, 0, 1, 0]], float)] * 3
    for name in ("compare_graphs_bayesian_shd", "compare_graphs_bayesian_dist",
                 "compare_graphs_bayesian_cover", "compare_graph_distribution"):
        assert getattr(tgr, name)(true, graphs) == getattr(jgr, name)(true, graphs), name
    assert tgr.structural_hamming_distance(true, graphs[0]) == jgr.structural_hamming_distance(
        true, graphs[0])
    w_true, w_est = np.triu(np.ones((5, 5)), 1), (rng.uniform(size=(5, 5)) < 0.3) * 1.0
    assert tgr.graph_shd(w_true, w_est) == jgr.graph_shd(w_true, w_est)
    g = np.stack(graphs)
    assert tgr.compute_graphs_bayesian_diversity(g, 3) == jgr.compute_graphs_bayesian_diversity(
        g, 3)
    assert tgr.compute_graphs_sparsity(g) == jgr.compute_graphs_sparsity(g)
