"""The port's CNF drift-net zoo (cfm_tpu_torch/models/diffeq.py) against
flax's (cfm_tpu/models/diffeq.py), through
``models/convert.variables_from_flax``, on shared numpy inputs and seeded
weights (``tests/helpers/flax_variables.py``): every linear
and conv layer type (strides 1, 2 and -2, the transposed conv at an odd and
an even size, flax's "SAME" padding where it splits unevenly), ``ODEnet``,
``ConvODEnet`` with squeezes, ``HyperConv2d``, the gated pairs, the
containers, ``BasicResBlock`` / ``ResNetDiffEq`` (their GroupNorms through
the port's GroupNorm wrapper, whose CPU path is the plain version),
``squeeze2d``'s NHWC channel order and ``AutoencoderDiffEqNet``. Forwards
within 1e-5 and parameter gradients within 1e-4, each relative to the
tensor's max-abs (or to 1e-3 of the largest leaf's, where that is more)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cfm_tpu.models import diffeq as jd
from cfm_tpu_torch.models import diffeq as td
from cfm_tpu_torch.models.convert import variables_from_flax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from flax_variables import fast_jit, random_variables  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU work: the suite runs six
    workers on the machine's cores, and torch's OpenMP pool of one thread a
    core then waits on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(out, ref, rtol=1e-5, err_msg=""):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30),
                               err_msg=err_msg)


def _sq(out):
    """The sum of squares of an output or of each part of a tuple."""
    parts = out if isinstance(out, tuple) else (out,)
    return sum((p * p).sum() for p in parts)


def _check(jmod, tmod, *args, seed=0, floor=1e-3):
    """Seeded flax variables for ``args`` (``random_variables``), loaded into
    the port module; hold the forward and the
    gradients of the sum of squares in the parameters. ``args``: numpy
    (t, x) or (x,)."""
    jargs = [jnp.asarray(a) for a in args]
    variables = random_variables(jmod, *jargs, seed=seed)
    tmod.load_state_dict(variables_from_flax(variables), strict=True)
    targs = [torch.from_numpy(np.array(a)) for a in args]

    def forward(p):
        out = jmod.apply({"params": p}, *jargs)
        return _sq(out), out

    (_, ref), g = fast_jit(jax.value_and_grad(forward, has_aux=True))(variables["params"])
    out = tmod(*targs)
    for o, r in zip(out if isinstance(out, tuple) else (out,),
                    ref if isinstance(ref, tuple) else (ref,)):
        _close(o, r)
    _sq(out).backward()
    want = variables_from_flax({"params": g})
    top = max(float(v.abs().max()) for v in want.values())
    for name, p in tmod.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        w = want[name].numpy()
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(w).max(), floor * top), err_msg=name)
    return out


def _tx(bs=6, shape=(3,), seed=0, same_t=False):
    rng = np.random.default_rng(seed)
    t = np.full(bs, 0.37, np.float32) if same_t else rng.uniform(size=bs).astype(np.float32)
    return t, rng.standard_normal((bs,) + shape).astype(np.float32)


LINEAR = ["ignore", "concat", "concat_v2", "squash", "concatsquash", "hyper", "blend"]


@pytest.mark.parametrize("kind", LINEAR)
def test_linear_layer_matches_flax(kind):
    t, x = _tx()
    jcls, tcls = jd._LAYER_TYPES[kind], td._LAYER_TYPES[kind]
    _check(jcls(out_dim=5), tcls(3, 5), t, x)
    # A scalar t broadcast over the batch.
    variables = random_variables(jcls(out_dim=5), 0.5, jnp.asarray(x), seed=1)
    m = tcls(3, 5)
    m.load_state_dict(variables_from_flax(variables))
    _close(m(0.5, torch.from_numpy(x)), jcls(out_dim=5).apply(variables, 0.5, jnp.asarray(x)))


@pytest.mark.parametrize("kind,act", [(k, a) for k, a in zip(LINEAR, [
    "tanh", "relu", "softplus", "elu", "swish", "square", "identity"])])
def test_odenet_matches_flax(kind, act):
    t, x = _tx(shape=(2,), seed=1)
    _check(jd.ODEnet(hidden_dims=(16, 8), out_dim=2, layer_type=kind, nonlinearity=act),
           td.ODEnet(2, (16, 8), 2, layer_type=kind, nonlinearity=act), t, x)


def test_gated_linear_matches_flax():
    _, x = _tx(seed=2)
    _check(jd.GatedLinear(out_dim=4), td.GatedLinear(3, 4), x)


CONV = ["ignore", "concat", "concat_v2", "squash", "concatsquash", "concatcoord", "blend"]


@pytest.mark.parametrize("kind,stride", [(k, 1) for k in CONV] + [
    ("concat", 2), ("concatsquash", 2), ("concat", -2), ("blend", -2)])
def test_conv_layer_matches_flax(kind, stride):
    """Every type at stride 1, and the two strided convs every type shares
    (``_Conv``, ``_ConvTranspose``) through a few of them: 7x7 inputs,
    where stride 2 (k = 4) pads (1, 2), flax's uneven "SAME" split, and -2
    is the k = 4 transposed conv to 14x14."""
    t, x = _tx(bs=2, shape=(7, 7, 3), seed=3)
    kw = {1: {}, 2: dict(ksize=4, stride=2), -2: dict(ksize=4, stride=2, transpose=True)}[stride]
    out = _check(jd._CONV_LAYER_TYPES[kind](out_channels=4, **kw),
                 td._CONV_LAYER_TYPES[kind](3, 4, **kw), t, x)
    assert out.shape == (2, {1: 7, 2: 4, -2: 14}[stride],) * 1 + out.shape[2:]


@pytest.mark.parametrize("ksize,stride,size", [(4, 2, 8), (3, 2, 5), (2, 3, 4), (3, 1, 6)])
def test_conv_transpose_matches_flax(ksize, stride, size):
    """flax ``ConvTranspose`` ("SAME", unflipped kernel) at even and odd
    sizes; k = 3, s = 2 and k = 2, s = 3 pad the dilated input unevenly
    ((2, 1) and (1, 2)), the port's dilated-correlation branch; the others
    take ``conv_transpose2d``. The kernel is not symmetric, so a flipped
    kernel would be caught."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    conv = lambda: jd._conv(5, ksize, stride, transpose=True)

    class Wrap(jd.nn.Module):
        @jd.nn.compact
        def __call__(self, x):
            return conv()(x)

    tmod = td._ConvTranspose(3, 5, ksize, stride)
    variables = random_variables(Wrap(), jnp.asarray(x), seed=2)
    inner = variables["params"]["ConvTranspose_0"]
    tmod.load_state_dict(variables_from_flax({"params": inner}))
    out = tmod(torch.from_numpy(x))
    ref = Wrap().apply(variables, jnp.asarray(x))
    assert out.shape == (2, size * stride, size * stride, 5)
    _close(out, ref)
    flipped = td._ConvTranspose(3, 5, ksize, stride)
    flipped.load_state_dict({"weight": tmod.weight.flip(2, 3), "bias": tmod.bias})
    assert (flipped(torch.from_numpy(x)) - out).abs().max() > 1e-3


def test_transpose_and_same_padding_rules():
    assert td.same_padding(7, 4, 2) == (1, 2) and td.same_padding(8, 4, 2) == (1, 1)
    assert td.same_padding(7, 3, 1) == (1, 1) and td.same_padding(5, 1, 1) == (0, 0)
    assert td.transpose_padding(4, 2) == (2, 2) and td.transpose_padding(3, 2) == (2, 1)
    assert td.transpose_padding(2, 3) == (1, 2) and td.transpose_padding(3, 1) == (1, 1)


def test_hyper_conv_matches_flax():
    """The kernel from the batch's first t, shared by the batch."""
    t, x = _tx(bs=3, shape=(6, 6, 2), seed=5)
    m = td.HyperConv2d(2, 3)
    out = _check(jd.HyperConv2d(in_channels=2, out_channels=3), m, t, x)
    _close(out, m(float(t[0]), torch.from_numpy(x)).detach().numpy())


@pytest.mark.parametrize("transpose", [False, True])
def test_gated_conv_matches_flax(transpose):
    _, x = _tx(bs=2, shape=(5, 5, 2), seed=6)
    jcls = jd.GatedConvTranspose if transpose else jd.GatedConv
    tcls = td.GatedConvTranspose if transpose else td.GatedConv
    _check(jcls(out_channels=3, ksize=4, stride=2), tcls(2, 3, ksize=4, stride=2), x)


@pytest.mark.parametrize("kind,strides,squeeze,act", [
    ("concatsquash", None, 0, "softplus"),
    ("concat", (1, 2, -2, 1), 1, "softplus"),
    ("blend", (1, 1, 1), 0, "tanh"),
    ("concatcoord", (2, -2), 0, "swish"),
])
def test_conv_odenet_matches_flax(kind, strides, squeeze, act):
    t, x = _tx(bs=2, shape=(8, 8, 1), seed=7, same_t=True)
    hidden = (8,) * (len(strides) - 1 if strides else 2)
    out_ch = 4 ** squeeze
    out = _check(jd.ConvODEnet(hidden_channels=hidden, out_channels=out_ch, layer_type=kind,
                               nonlinearity=act, strides=strides, num_squeeze=squeeze),
                 td.ConvODEnet(1, hidden, out_ch, layer_type=kind, nonlinearity=act,
                               strides=strides, num_squeeze=squeeze), t, x)
    assert out.shape == x.shape


def test_containers_match_flax():
    """``DiffEqWrapper`` (a time-free layer), ``SequentialDiffEq``,
    ``MixtureODELayer`` (each sample weighted by its own t) and
    ``ReshapeDiffEq`` around a conv net."""
    t, x = _tx(bs=5, shape=(4,), seed=8)
    jseq = jd.SequentialDiffEq(layers=(jd.ConcatLinear(out_dim=6),
                                       jd.diffeq_wrap(jd.GatedLinear(out_dim=6)),
                                       jd.ConcatSquashLinear(out_dim=4)))
    tseq = td.SequentialDiffEq([td.ConcatLinear(4, 6), td.diffeq_wrap(td.GatedLinear(6, 6)),
                                td.ConcatSquashLinear(6, 4)])
    _check(jseq, tseq, t, x)
    jmix = jd.MixtureODELayer(experts=(jd.ConcatLinear(out_dim=4), jd.BlendLinear(out_dim=4),
                                       jd.SquashLinear(out_dim=4)))
    tmix = td.MixtureODELayer([td.ConcatLinear(4, 4), td.BlendLinear(4, 4),
                               td.SquashLinear(4, 4)])
    out = _check(jmix, tmix, t, x)
    # Per-sample weights: sample i alone gives row i.
    alone = tmix(torch.from_numpy(t[2:3]), torch.from_numpy(x[2:3]))
    _close(alone[0], out[2].detach().numpy())
    tr, xr = _tx(bs=2, shape=(36,), seed=9)
    _check(jd.ReshapeDiffEq(input_shape=(6, 6, 1),
                            net=jd.ConvODEnet(hidden_channels=(4,), out_channels=1)),
           td.ReshapeDiffEq((6, 6, 1), td.ConvODEnet(1, (4,), 1)), tr, xr)


@pytest.mark.parametrize("dim,width,conv", [(1, 32, "concatcoord"), (2, 8, "concatsquash")])
def test_resnet_diffeq_matches_flax(dim, width, conv):
    """GroupNorm(min(16, C), eps 1e-4, f32) through the port's wrapper (the
    plain two-pass version on the CPU) against flax's nn.GroupNorm (one-pass
    E[x^2] - E[x]^2): 16 groups of 2 channels, or 8 of 1. Through two
    blocks of two GroupNorms each the gradients are held within 2e-4, the
    variances' roundings apart."""
    t, x = _tx(bs=2, shape=(6, 6, dim), seed=10, same_t=True)
    x = 2.0 * x + 0.5
    _check(jd.ResNetDiffEq(dim=dim, intermediate_dim=width, n_resblocks=2, conv_layer=conv),
           td.ResNetDiffEq(dim, width, 2, conv_layer=conv), t, x, floor=1e-2)
    _check(jd.BasicResBlock(dim=width, conv_layer=conv), td.BasicResBlock(width, conv),
           *_tx(bs=2, shape=(5, 5, width), seed=11), floor=1e-2)


def test_resnet_diffeq_routes_group_norm_through_the_wrapper(monkeypatch):
    """Every GroupNorm of the net calls ``fused_group_norm_silu`` without the
    SiLU at eps 1e-4, with min(16, C) groups."""
    calls = []
    real = td.fused_group_norm_silu

    def spy(x, scale, bias, num_groups, eps, apply_silu):
        calls.append((tuple(x.shape), num_groups, eps, apply_silu))
        return real(x, scale, bias, num_groups, eps, apply_silu)

    monkeypatch.setattr(td, "fused_group_norm_silu", spy)
    td.ResNetDiffEq(1, 64, 4)(0.5, torch.zeros(2, 6, 6, 1))
    assert calls == [((2, 6, 6, 64), 16, 1e-4, False)] * 9


def test_squeeze_order_matches_jax_not_pixel_unshuffle():
    x = np.arange(2 * 4 * 6 * 3, dtype=np.float32).reshape(2, 4, 6, 3)
    out = td.squeeze2d(torch.from_numpy(x), 2)
    _close(out, jd.squeeze2d(jnp.asarray(x), 2), 0)
    _close(td.unsqueeze2d(out, 2), x, 0)
    _close(td.unsqueeze2d(torch.from_numpy(x), 1), x, 0)
    nchw = F.pixel_unshuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    assert not torch.equal(nchw, out)
    y = np.random.default_rng(0).standard_normal((1, 2, 3, 8)).astype(np.float32)
    _close(td.unsqueeze2d(torch.from_numpy(y), 2), jd.unsqueeze2d(jnp.asarray(y), 2), 0)
    layer, logp = td.SqueezeLayer(2), torch.ones(2)
    z, lp = layer(torch.from_numpy(x), logp)
    assert lp is logp and torch.equal(layer(z, reverse=True), torch.from_numpy(x))


@pytest.mark.parametrize("conv,kind", [(False, "concat"), (False, "squash"), (False, "blend"),
                                       (False, "concatcoord"), (True, "concat"),
                                       (True, "ignore"), (True, "concatcoord")])
def test_autoencoder_diffeq_net_matches_flax(conv, kind):
    if conv:
        t, x = _tx(bs=2, shape=(8, 8, 2), seed=12, same_t=True)
        strides = (2, 1, -2)
        jm = jd.AutoencoderDiffEqNet(hidden_dims=(6, 6), out_dim=2, conv=True, layer_type=kind,
                                     strides=strides)
        tm = td.AutoencoderDiffEqNet(2, (6, 6), 2, conv=True, layer_type=kind, strides=strides)
    else:
        t, x = _tx(bs=4, shape=(3,), seed=12)
        jm = jd.AutoencoderDiffEqNet(hidden_dims=(8, 6, 8), out_dim=3, layer_type=kind)
        tm = td.AutoencoderDiffEqNet(3, (8, 6, 8), 3, layer_type=kind)
    h, dx = _check(jm, tm, t, x)
    assert dx.shape == x.shape


INIT_CASES = [
    ("odenet", lambda: jd.ODEnet(hidden_dims=(64, 64), out_dim=2),
     lambda s: td.ODEnet(2, (64, 64), 2, seed=s), (2,)),
    ("conv_odenet", lambda: jd.ConvODEnet(hidden_channels=(16, 16), out_channels=1,
                                          layer_type="concat"),
     lambda s: td.ConvODEnet(1, (16, 16), 1, layer_type="concat", seed=s), (6, 6, 1)),
    ("resnet", lambda: jd.ResNetDiffEq(dim=1, intermediate_dim=16, n_resblocks=1),
     lambda s: td.ResNetDiffEq(1, 16, 1, seed=s), (6, 6, 1)),
    ("hyper_conv", lambda: jd.HyperConv2d(in_channels=2, out_channels=4),
     lambda s: td.HyperConv2d(2, 4, seed=s), (6, 6, 2)),
    ("gated_transpose", lambda: jd.GatedConvTranspose(out_channels=8, ksize=4, stride=2),
     lambda s: td.GatedConvTranspose(4, 8, ksize=4, stride=2, seed=s), (5, 5, 4)),
]


@pytest.mark.parametrize("name,jmake,tmake,shape", INIT_CASES, ids=[c[0] for c in INIT_CASES])
def test_init_statistics_match_flax(name, jmake, tmake, shape):
    """Over 6 seeds each kernel's std within four standard errors of flax's
    (lecun-normal, fan-in kh * kw * in for convs), no entry beyond flax's
    truncation, zero biases, unit GroupNorm scales."""
    x = jnp.zeros((2,) + shape)
    args = (x,) if name == "gated_transpose" else (jnp.zeros((2,)), x)
    flax, port = {}, {}
    init = fast_jit(jmake().init)
    for seed in range(6):
        for k, v in variables_from_flax(init(jax.random.PRNGKey(seed), *args)).items():
            flax.setdefault(k, []).append(v.numpy().ravel())
        for k, v in tmake(seed).state_dict().items():
            port.setdefault(k, []).append(v.numpy().ravel())
    assert flax.keys() == port.keys()
    for k in flax:
        f, p = np.concatenate(flax[k]), np.concatenate(port[k])
        if k.endswith("bias") or "GroupNorm" in k:
            np.testing.assert_array_equal(p, f, err_msg=k)
            continue
        assert abs(p.std() / f.std() - 1) < 4 / np.sqrt(2 * p.size), (k, p.std(), f.std())
        assert np.abs(p).max() <= f.std() * 2 / 0.87962566103423978 * 1.1, k
