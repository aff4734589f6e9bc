"""The port's FID pieces (cfm_tpu_torch/eval/fid.py, eval/inception.py)
against the JAX package's, on the CPU, on inputs drawn once with numpy:

- ``compute_statistics``, ``frechet_distance`` (with its eps fallback) and
  ``fid_from_features`` in float64, to 1e-10 relative;
- the tracking features given JAX's own kernels, to 1e-5 (float32); the
  port's kernels have JAX's shapes and scales;
- ``tf1_resize_bilinear`` and the pytorch-fid resize, to 1e-6 (values in
  0..255 and in [0, 1]);
- the InceptionV3 trunk given the same random weights (folded BatchNorm
  randomised as in ``tests/test_fid.py``), batch 1 at 299x299, in both
  modes, to 1e-4; the npz of ``port_torch_inception_weights`` loads in both
  packages.
"""

import os

import numpy as np
import pytest
import torch

from cfm_tpu_torch.eval import fid as tfid
from cfm_tpu_torch.eval import inception as tinc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tiny CPU models: the suite runs
    six workers on the machine's cores, and torch's OpenMP pool of one
    thread a core then waits on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _features(seed, n=300, d=24, shift=0.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d)) / np.sqrt(d)
    return (rng.standard_normal((n, d)) @ a + shift).astype(np.float32)


def test_statistics_frechet_distance_and_fid_match_jax():
    from cfm_tpu.eval import fid as jfid

    g, r = _features(0), _features(1, shift=0.3)
    for t, j in zip(tfid.compute_statistics(g), jfid.compute_statistics(g)):
        assert t.dtype == np.float64
        np.testing.assert_allclose(t, j, rtol=1e-10, atol=0)
    mu1, s1 = jfid.compute_statistics(g)
    mu2, s2 = jfid.compute_statistics(r)
    np.testing.assert_allclose(tfid.frechet_distance(mu1, s1, mu2, s2),
                               jfid.frechet_distance(mu1, s1, mu2, s2), rtol=1e-10)
    np.testing.assert_allclose(tfid.fid_from_features(g, r), jfid.fid_from_features(g, r),
                               rtol=1e-10)
    np.testing.assert_allclose(tfid.fid_from_features(torch.from_numpy(g), r),
                               jfid.fid_from_features(g, r), rtol=1e-10)
    assert abs(tfid.fid_from_features(g, g)) < 1e-8
    # Singular covariances (fewer samples than dimensions): the eps fallback.
    few, other = _features(2, n=10), _features(3, n=10)
    np.testing.assert_allclose(tfid.fid_from_features(few, other),
                               jfid.fid_from_features(few, other), rtol=1e-8)


@pytest.mark.parametrize("shape", [(28, 28, 1), (32, 32, 3), (7, 9, 3)])
def test_tracking_features_match_jax_given_its_kernels(shape):
    """JAX's kernels (its ``jax.random`` draws, read out of its closure) go
    through the port's ``tracking_features``: the same features to 1e-5."""
    from cfm_tpu.eval import fid as jfid

    import jax.numpy as jnp

    fn = jfid.make_tracking_feature_fn(shape)
    env = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
    kernels = [torch.from_numpy(np.array(k)) for k in env["kernels"]]
    proj = torch.from_numpy(np.array(env["proj"]))
    x = np.random.default_rng(5).integers(0, 256, (6,) + shape).astype(np.uint8)
    want = np.asarray(fn(jnp.asarray(x)))
    got = tfid.tracking_features(torch.from_numpy(x), kernels, proj).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # The port's own draws: JAX's shapes, N(0, 2 / fan_in) and N(0, 1 / 128).
    own, own_proj = tfid.tracking_kernels(shape, device="cpu")
    assert [k.shape for k in own] == [k.shape for k in kernels]
    assert own_proj.shape == proj.shape == (128, 256)
    for k in own[1:]:
        fan_in = 9 * k.shape[2]
        assert abs(float(k.std()) * np.sqrt(fan_in / 2.0) - 1.0) < 0.05
    a = tfid.make_tracking_feature_fn(shape, device="cpu")(torch.from_numpy(x))
    assert a.shape == (6, 256) and torch.equal(
        a, tfid.make_tracking_feature_fn(shape, device="cpu")(torch.from_numpy(x)))


def test_batched_features_and_compute_fid():
    fn = tfid.make_tracking_feature_fn((8, 8, 3), device="cpu")
    rng = np.random.default_rng(6)
    a = rng.integers(0, 256, (37, 8, 8, 3)).astype(np.uint8)
    b = rng.integers(0, 128, (29, 8, 8, 3)).astype(np.uint8)
    whole = fn(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(tfid.batched_features(fn, a, batch_size=10, device="cpu"),
                               whole, rtol=1e-6, atol=1e-6)
    fid = tfid.compute_fid(fn, a, b, batch_size=16, device="cpu")
    assert fid > tfid.compute_fid(fn, a, a[::-1].copy(), device="cpu") - 1e-9 and fid > 0


@pytest.mark.parametrize("hw", [(32, 32), (28, 28), (299, 299), (40, 23)])
def test_resizes_match_jax(hw):
    import jax
    import jax.numpy as jnp

    from cfm_tpu.eval.inception import tf1_resize_bilinear as jtf

    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, (2,) + hw + (3,)).astype(np.float32)
    np.testing.assert_allclose(tinc.tf1_resize_bilinear(torch.from_numpy(x), 299, 299).numpy(),
                               np.asarray(jtf(jnp.asarray(x), 299, 299)), rtol=0, atol=1e-6 * 255)
    x01 = x / 255.0
    want = np.asarray(jax.image.resize(jnp.asarray(x01), (2, 299, 299, 3), method="bilinear"))
    got = tinc.pytorch_fid_resize(torch.from_numpy(x01), 299, 299).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _random_npz_params(seed=3):
    """Random weights in the npz layout for the port's module shapes: kernels
    N(0, 2 / fan_in) HWIO, BN scale 1, mean and bias N(0, 0.1), var
    U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    model = tinc.InceptionV3Features()
    out = {}
    bn = {"weight": "bn_scale", "bias": "bn_bias", "running_mean": "bn_mean",
          "running_var": "bn_var"}
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        *mod, sub, leaf = name.split(".")
        path, shape = "/".join(mod), tuple(t.shape)
        if sub == "conv":
            w = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
            out[f"{path}/conv/kernel"] = w.transpose(2, 3, 1, 0).astype(np.float32)
        elif leaf == "weight":
            out[f"{path}/bn_scale"] = np.ones(shape, np.float32)
        elif leaf == "running_var":
            out[f"{path}/bn_var"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            out[f"{path}/{bn[leaf]}"] = rng.normal(0, 0.1, shape).astype(np.float32)
    return out


def _jax_params(flat):
    params = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return {"params": params}


@pytest.fixture(scope="module")
def npz_params():
    return _random_npz_params()


@pytest.mark.parametrize("mode", ["pytorch_fid", "legacy_tensorflow"])
def test_inception_trunk_matches_jax(mode, npz_params):
    import jax.numpy as jnp

    from cfm_tpu.eval.inception import InceptionV3Features as JInception

    x = np.random.default_rng(8).integers(0, 256, (1, 299, 299, 3)).astype(np.uint8)
    want = np.asarray(JInception(mode=mode).apply(_jax_params(npz_params), jnp.asarray(x)))
    model = tinc.InceptionV3Features(mode=mode).load_params(npz_params)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 2048) and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_inception_npz_round_trip_serves_both_packages(npz_params, tmp_path, monkeypatch):
    """The module's state dict carries pytorch-fid's names, so
    ``port_torch_inception_weights`` writes from it the npz that JAX's porter
    writes from the same dict and that both loaders read; the feature
    function reads it from ``CFM_TPU_INCEPTION_WEIGHTS`` and without it
    raises JAX's ``FileNotFoundError``."""
    from cfm_tpu.eval.inception import load_inception_params as jload
    from cfm_tpu.eval.inception import port_torch_inception_weights as jport

    model = tinc.InceptionV3Features().load_params(npz_params)
    sd = model.state_dict()
    assert "Mixed_5b.branch1x1.conv.weight" in sd and "Mixed_7c.branch_pool.bn.running_var" in sd
    sd_with_head = dict(sd, **{"fc.weight": torch.zeros(3, 2048), "AuxLogits.conv0.conv.weight":
                               torch.zeros(1)})
    ours, theirs = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tinc.port_torch_inception_weights(sd_with_head, ours)
    jport({k: v.numpy() for k, v in sd_with_head.items()}, theirs)
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.files) == sorted(b.files) and len(a.files) == len(sd)
    assert all(np.array_equal(a[k], b[k]) for k in a.files)
    loaded = tinc.load_inception_params(ours)
    jtree = jload(ours)["params"]
    for key, value in loaded.items():
        node = jtree
        for p in key.split("/"):
            node = node[p]
        np.testing.assert_array_equal(np.asarray(node), value)
        np.testing.assert_array_equal(value, npz_params[key])
    with pytest.raises(ValueError, match="missing"):
        tinc.InceptionV3Features().load_params({k: v for k, v in loaded.items()
                                                if "Mixed_7c" not in k})
    monkeypatch.delenv("CFM_TPU_INCEPTION_WEIGHTS", raising=False)
    with pytest.raises(FileNotFoundError, match="port_torch_inception_weights"):
        tfid.inception_feature_fn(device="cpu")
    monkeypatch.setenv("CFM_TPU_INCEPTION_WEIGHTS", ours)
    fn = tfid.inception_feature_fn(mode="pytorch_fid", device="cpu")
    x = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (1, 32, 32, 1)).astype(
        np.uint8))
    with torch.inference_mode():
        assert torch.equal(fn(x), model(x)) and fn(x).shape == (1, 2048)
    assert os.path.exists(ours)
