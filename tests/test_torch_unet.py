"""The port's UNet (cfm_tpu_torch/models/unet.py, convert.py) against flax.

The forward runs at a small configuration that keeps the CIFAR-10 recipe's
routing: at 8x8 with C=128 the attention blocks pass the fused-block gate
(the JAX side runs its block kernel in Pallas interpret mode, the port its
plain version), while ``mid_attn`` at 4x4 (S=16) takes the composition on
both sides. Every parameter, zero-initialised ones included, is randomised.
The ``cuda``-marked test holds the 32x32 ImageNet-64 block's streamed route
against the plain composition on the card, whose machine has no JAX:
``python -m pytest tests/test_torch_unet.py -m cuda -q``.
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from cfm_tpu.models import unet as junet
    from cfm_tpu.ops import pallas_attn_block as pab
    from cfm_tpu.ops.pallas_groupnorm import _gn_silu_reference
except ImportError:  # the card's machine: only the cuda-marked test runs there
    jax = jnp = junet = pab = _gn_silu_reference = None

from cfm_tpu_torch.models import unet as tunet
from cfm_tpu_torch.models.convert import unet_params_from_flax
from cfm_tpu_torch.ops.groupnorm import gn_silu_reference


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU work: the suite runs six
    workers on the machine's cores, and torch's OpenMP pool of one thread a
    core then waits on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SMALL = dict(dim=(16, 16, 3), num_channels=64, num_res_blocks=1, channel_mult=(1, 2, 2),
             num_heads=4, num_head_channels=64, attention_resolutions="8")


def random_flax_params(m, *init_args, seed=0):
    """A random parameter tree of the flax module ``m``, drawn with numpy on
    the tree's shapes: kernels N(0, 1/fan_in), GroupNorm scales 1 + N(0,
    0.01), everything else (biases, zero-initialised layers) N(0, 0.01)."""
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0), *init_args)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        z = rng.standard_normal(s.shape)
        if name.endswith("kernel") and name != "proj_kernel":
            z = z / np.sqrt(np.prod(s.shape[:-1]) if name == "kernel" else s.shape[0])
        else:
            z = (1.0 if name == "scale" else 0.0) + 0.1 * z
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _flax_params(cfg, jdtype, seed=0):
    m = junet.UNetModelWrapper(**cfg, dtype=jdtype)
    return m, random_flax_params(m, jnp.zeros((1,)), jnp.zeros((1,) + cfg["dim"]), seed=seed)


def _port_model(cfg, tdtype, params):
    model = tunet.UNetModelWrapper(**cfg, dtype=tdtype, device="cpu")
    model.load_state_dict(unet_params_from_flax(params), strict=True)
    return model


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-4), ("bf16", 3e-2)])
def test_unet_forward_matches_flax(monkeypatch, dtype, tol):
    """f32 at 1e-4 (summation order only); bf16 at 3e-2 of the output's
    scale, since convs, matmuls and adds round to bf16 at each layer and the
    two frameworks round some of them at other points."""
    monkeypatch.setattr(pab, "INTERPRET", True)
    jdtype, tdtype = {"f32": (jnp.float32, torch.float32),
                      "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    m, params = _flax_params(SMALL, jdtype)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([0.2, 0.7], np.float32)
    y_jax = np.asarray(m.apply({"params": params}, jnp.asarray(t), jnp.asarray(x)), np.float32)
    model = _port_model(SMALL, tdtype, params)
    assert [n for n, mod in model.named_modules()
            if isinstance(mod, tunet.AttentionBlock)] == [
        "down1_attn0", "mid_attn", "up1_attn0", "up1_attn1"]
    with torch.no_grad():
        y = model(torch.from_numpy(t), torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (2, 16, 16, 3)
    scale = np.abs(y_jax).max()
    np.testing.assert_allclose(y.numpy() / scale, y_jax / scale, atol=tol, rtol=tol)


@pytest.mark.parametrize("variant", [
    dict(use_scale_shift_norm=True),
    dict(resblock_updown=True),
    dict(class_cond=True, num_classes=5),
    dict(num_head_channels=-1, num_heads=2, learn_sigma=True),
])
def test_unet_variants_match_flax(variant):
    """The UNetModel options outside the recipe, in f32 at 1e-4, on a tiny
    configuration whose attention takes the composition."""
    cfg = dict(dim=(8, 8, 3), num_channels=16, num_res_blocks=1, channel_mult=(1, 2),
               num_head_channels=8, attention_resolutions="4")
    cfg.update(variant)
    m = junet.UNetModelWrapper(**cfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    t = np.array([0.3, 0.9], np.float32)
    extra_j, extra_t = (), ()
    if cfg.get("class_cond"):
        extra_j, extra_t = (jnp.array([1, 4]),), (torch.tensor([1, 4]),)
    params = random_flax_params(m, jnp.asarray(t), jnp.asarray(x), *extra_j)
    y_jax = np.asarray(m.apply({"params": params}, jnp.asarray(t), jnp.asarray(x), *extra_j))
    model = _port_model(cfg, torch.float32, params)
    with torch.no_grad():
        y = model(torch.from_numpy(t), torch.from_numpy(x), *extra_t).numpy()
    scale = np.abs(y_jax).max()
    np.testing.assert_allclose(y / scale, y_jax / scale, atol=1e-4, rtol=1e-4)


def test_converter_round_trip():
    """Every flax leaf lands on exactly one state_dict entry, with the layout
    the torch module expects, and back."""
    _, params = _flax_params(SMALL, jnp.float32)
    sd = unet_params_from_flax(params)
    model = tunet.UNetModelWrapper(**SMALL, device="cpu")
    assert set(sd) == set(model.state_dict())
    assert all(sd[k].shape == v.shape for k, v in model.state_dict().items())
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert len(sd) == n_leaves
    p = params
    # conv HWIO -> OIHW, Dense (in, out) -> (out, in)
    np.testing.assert_array_equal(sd["Conv_0.weight"].numpy().transpose(2, 3, 1, 0),
                                  p["Conv_0"]["kernel"])
    np.testing.assert_array_equal(sd["down0_res0.Dense_0.weight"].numpy().T,
                                  p["down0_res0"]["Dense_0"]["kernel"])
    np.testing.assert_array_equal(sd["down1_down.Conv_0.bias"].numpy(),
                                  p["down1_down"]["Conv_0"]["bias"])
    np.testing.assert_array_equal(sd["mid_attn.GroupNorm32_0.weight"].numpy(),
                                  p["mid_attn"]["GroupNorm32_0"]["scale"])
    # attention: [k][h][d] column order, as the JAX block kernel takes it
    a = p["down1_attn0"]
    C, _, H, D = a["qkv_kernel"].shape
    wq = sd["down1_attn0.qkv_weight"].numpy()
    for k, h in ((0, 0), (1, 1), (2, H - 1)):
        np.testing.assert_array_equal(wq[:, (k * H + h) * D:(k * H + h + 1) * D],
                                      a["qkv_kernel"][:, k, h, :])
    np.testing.assert_array_equal(sd["down1_attn0.qkv_bias"].numpy().reshape(3, H, D),
                                  a["qkv_bias"])
    np.testing.assert_array_equal(sd["down1_attn0.proj_weight"].numpy().reshape(H, D, C),
                                  a["proj_kernel"])


def test_downsample_pads_like_xla_same():
    """Stride-2 3x3 conv at 32->16 pads (0, 1), not torch's (1, 1)."""
    import flax.linen as nn

    assert tunet._same_pads(32, 3, 2) == (0, 1)
    assert tunet._same_pads(16, 3, 1) == (1, 1)
    assert tunet._same_pads(7, 3, 2) == (1, 1)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    conv = nn.Conv(5, (3, 3), strides=(2, 2), padding="SAME")
    params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {"kernel": np.asarray(params["kernel"]),
              "bias": rng.standard_normal(5).astype(np.float32)}
    y_jax = np.asarray(conv.apply({"params": params}, jnp.asarray(x)))
    down = tunet.Downsample(True, 4, 5, torch.float32)
    down.load_state_dict(unet_params_from_flax({"Conv_0": params}))
    with torch.no_grad():
        y = down(torch.from_numpy(x)).numpy()
    assert y.shape == (2, 16, 16, 5)
    np.testing.assert_allclose(y, y_jax, atol=1e-5, rtol=1e-5)
    sym = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                                     down.Conv_0.weight, down.Conv_0.bias, stride=2, padding=1)
    assert not np.allclose(sym.permute(0, 2, 3, 1).detach().numpy(), y_jax, atol=1e-3)


@pytest.mark.parametrize("c,groups", [(48, 24), (256, 32), (64, 32), (3, 3), (96, 32), (20, 20)])
def test_group_norm_groups_and_values(c, groups):
    assert tunet.gn_groups(c) == groups
    rng = np.random.default_rng(4)
    x = (3.0 + rng.standard_normal((2, 4, 4, c))).astype(np.float32)
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    gn = junet.GroupNorm32(fuse_silu=True)
    y_jax = gn.apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    port = tunet.GroupNorm32(c, fuse_silu=True)
    port.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        y = port(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("silu", [False, True])
def test_gn_silu_reference_matches_jax_bf16(silu):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    y_jax = _gn_silu_reference(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale),
                               jnp.asarray(bias), 32, 1e-5, silu)
    y = gn_silu_reference(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(scale),
                          torch.from_numpy(bias), 32, 1e-5, silu)
    assert y.dtype == torch.bfloat16
    # one bf16 rounding of the same f32 value; a tie may flip by one ulp
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_jax, np.float32),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("dim", [64, 33])
def test_timestep_embedding_matches_jax(dim):
    t = np.array([0.0, 0.25, 0.5, 1.0], np.float32)
    ref = np.asarray(junet.timestep_embedding(jnp.asarray(t), dim))
    out = tunet.timestep_embedding(torch.from_numpy(t), dim).numpy()
    assert out.shape == (4, dim)
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)


def test_train_mode_raises():
    """train=True with dropout 0 is eval mode; with dropout 0.1 the output
    differs from eval mode and is reproducible from the same generator; with
    dropout and no generator for the masks it raises."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 3)).astype(np.float32))
    t = torch.tensor([0.3, 0.8])
    _, params = _flax_params(SMALL, jnp.float32, seed=3)
    sd = unet_params_from_flax(params)
    plain = tunet.UNetModelWrapper(**SMALL, device="cpu")
    plain.load_state_dict(sd)
    with torch.no_grad():
        y_eval = plain(t, x)
        assert torch.equal(plain(t, x, train=True, generator=torch.Generator()), y_eval)
        drop = tunet.UNetModelWrapper(**SMALL, dropout=0.1, device="cpu")
        drop.load_state_dict(sd)
        assert torch.equal(drop(t, x), y_eval)
        y1 = drop(t, x, train=True, generator=torch.Generator().manual_seed(4))
        y2 = drop(t, x, train=True, generator=torch.Generator().manual_seed(4))
        y3 = drop(t, x, train=True, generator=torch.Generator().manual_seed(5))
    assert torch.equal(y1, y2)
    assert not torch.allclose(y1, y_eval, atol=1e-4) and not torch.allclose(y1, y3, atol=1e-4)
    with pytest.raises(ValueError, match="Generator"):
        drop(t, x, train=True)


@pytest.mark.parametrize("rate", [0.001, 0.1, 0.5, 0.999])
def test_fast_dropout_threshold_and_values(rate):
    """thr follows the JAX formula; the kept fraction is within 3 sigma of
    thr/256; kept values are exactly x * (256/thr) in x's dtype, dropped ones 0."""
    thr = min(255, max(1, int(round((1.0 - rate) * 256.0))))
    assert tunet.FastDropout.threshold(rate) == thr
    n = 1 << 16
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.rand(n, generator=torch.Generator().manual_seed(1)) + 0.5).to(dtype)
        y = tunet.FastDropout(rate)(x, train=True, generator=torch.Generator().manual_seed(2))
        kept = y != 0
        p = thr / 256
        assert abs(kept.float().mean().item() - p) <= 3 * np.sqrt(p * (1 - p) / n)
        scale = torch.tensor(256.0 / thr, dtype=dtype)
        assert torch.equal(y[kept], x[kept] * scale) and y.dtype == dtype
    assert torch.equal(tunet.FastDropout(0.0)(x, train=True), x)
    assert torch.equal(tunet.FastDropout(1.0)(x, train=True), torch.zeros_like(x))
    assert torch.equal(tunet.FastDropout(rate)(x), x)


def test_fast_dropout_matches_jax_given_the_same_bits(monkeypatch):
    """With the uint8 draws replaced by the same bits on both sides, the
    port's FastDropout equals flax's, in f32 and bf16."""
    bits = np.random.default_rng(3).integers(0, 256, (4, 8, 8, 16), dtype=np.uint8)
    monkeypatch.setattr(jax.random, "bits", lambda key, shape, dtype: jnp.asarray(bits))
    monkeypatch.setattr(torch, "randint", lambda *a, **k: torch.from_numpy(bits))
    x = np.random.default_rng(4).standard_normal(bits.shape).astype(np.float32)
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = junet.FastDropout(0.1).apply({}, jnp.asarray(x, jd), deterministic=False,
                                           rngs={"dropout": jax.random.PRNGKey(0)})
        out = tunet.FastDropout(0.1)(torch.from_numpy(x).to(td), train=True,
                                     generator=torch.Generator())
        np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))


# The ImageNet-64 UNet's routing at a CPU-sized width (chip_smoke.py's phase-5
# model): its 16x16 blocks (C = 64, one head of 64) take kernel #3, its 8x8
# blocks (C = 128) the fused block #1, its 4x4 blocks the plain composition,
# in f32 and in bf16; scale-shift norm, ResBlock up/down sampling, 10 classes.
IMAGENET_SMALL = dict(dim=(16, 16, 3), num_channels=64, channel_mult=(1, 2, 3), num_res_blocks=1,
                      num_head_channels=64, attention_resolutions="16,8,4",
                      use_scale_shift_norm=True, resblock_updown=True, class_cond=True,
                      num_classes=10)


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-4), ("bf16", 3e-2)])
def test_imagenet64_like_unet_forward_matches_flax(monkeypatch, dtype, tol):
    """As :func:`test_unet_forward_matches_flax`, with the JAX side running
    kernel #3 (``pallas_attention.INTERPRET``) and #1 in interpret mode."""
    from cfm_tpu.ops import pallas_attention as pa

    monkeypatch.setattr(pab, "INTERPRET", True)
    monkeypatch.setattr(pa, "INTERPRET", True)
    jdtype, tdtype = {"f32": (jnp.float32, torch.float32),
                      "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    m = junet.UNetModelWrapper(**IMAGENET_SMALL, dtype=jdtype)
    params = random_flax_params(m, jnp.zeros((1,)), jnp.zeros((1, 16, 16, 3)),
                                jnp.zeros((1,), jnp.int32), seed=5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t, y = np.array([0.4, 0.8], np.float32), np.array([3, 7])
    apply = jax.jit(m.apply)  # one compiled program: eager interpret mode takes 4-5 times longer
    y_jax = np.asarray(apply({"params": params}, jnp.asarray(t), jnp.asarray(x), jnp.asarray(y)),
                       np.float32)
    model = _port_model(IMAGENET_SMALL, tdtype, params)
    with torch.no_grad():
        out = model(torch.from_numpy(t), torch.from_numpy(x), torch.from_numpy(y))
    scale = np.abs(y_jax).max()
    np.testing.assert_allclose(out.numpy() / scale, y_jax / scale, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("side,C,route", [(8, 768, {"f32": "plain", "bf16": "#1"}),
                                          (16, 576, {"f32": "#3", "bf16": "#3"}),
                                          (32, 384, {"f32": "plain", "bf16": "plain"})])
def test_attention_blocks_route_as_in_jax_at_imagenet64_widths(monkeypatch, side, C, route,
                                                               dtype):
    """Each attention shape of the ImageNet-64 UNet (64 head channels) takes
    the route the JAX AttentionBlock's gates give it (``use_fused_block``,
    then ``_gate`` inside ``fused_attention_t``): the port's block, run on
    the CPU, is watched for which function it reaches."""
    from cfm_tpu.ops import pallas_attention as pa
    from cfm_tpu_torch.ops import attention as tatt

    monkeypatch.setattr(pab, "INTERPRET", True)   # lifts only the backend clauses
    monkeypatch.setattr(pa, "INTERPRET", True)
    jdtype, tdtype = {"f32": (jnp.float32, torch.float32),
                      "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    H, S = C // 64, side * side
    want = ("#1" if pab.use_fused_block(S, C, H, jdtype)
            else "#3" if pa._gate(H, S, 64, jnp.dtype(jdtype)) else "plain")
    assert want == route[dtype]
    seen = []
    for mod, name, tag in ((tunet, "fused_attention_block", "#1"), (tatt, "_forward", "#3"),
                           (tatt, "attn_reference_t", "plain")):
        def watch(*a, _f=getattr(mod, name), _tag=tag):
            seen.append(_tag)
            return _f(*a)
        monkeypatch.setattr(mod, name, watch)
    block = tunet.AttentionBlock(C, num_head_channels=64, dtype=tdtype)
    with torch.no_grad():
        block(torch.zeros(1, side, side, C, dtype=tdtype))
    assert seen[0] == want


def test_attention_pool_matches_flax():
    """f32 at 1e-5: the pool's own softmax on both sides."""
    m = junet.AttentionPool2d(embed_dim=32, num_heads=4, output_dim=7)
    x = np.random.default_rng(7).standard_normal((2, 4, 4, 32)).astype(np.float32)
    params = random_flax_params(m, jnp.asarray(x), seed=8)
    ref = np.asarray(m.apply({"params": params}, jnp.asarray(x)))
    pool = tunet.AttentionPool2d(16, 32, 4, 7)
    pool.load_state_dict(unet_params_from_flax(params), strict=True)
    with torch.no_grad():
        out = pool(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 7)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


_BASE = dict(in_channels=6, model_channels=16, out_channels=3, num_res_blocks=1,
             attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=8)


@pytest.mark.parametrize("low", [8, 5])
def test_super_res_model_matches_flax(low):
    """An even (8 -> 16, factor 2) and an odd (5 -> 16) low-resolution size:
    the bilinear resize alone to 1e-6, the model to 1e-4 of its output's
    scale."""
    import torch.nn.functional as F

    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    low_res = rng.standard_normal((2, low, low, 3)).astype(np.float32)
    t = np.array([0.1, 0.6], np.float32)
    resized = np.asarray(jax.image.resize(jnp.asarray(low_res), (2, 16, 16, 3), method="bilinear"))
    ours = F.interpolate(torch.from_numpy(low_res).permute(0, 3, 1, 2), size=(16, 16),
                         mode="bilinear", align_corners=False, antialias=False)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), resized, atol=1e-6, rtol=1e-6)
    m = junet.SuperResModel(base=junet.UNetModel(**_BASE))
    params = random_flax_params(m, jnp.asarray(t), jnp.asarray(x), jnp.asarray(low_res), seed=10)
    ref = np.asarray(m.apply({"params": params}, jnp.asarray(t), jnp.asarray(x),
                             jnp.asarray(low_res)))
    model = tunet.SuperResModel(tunet.UNetModel(**_BASE))
    model.load_state_dict(unet_params_from_flax(params), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(t), torch.from_numpy(x), torch.from_numpy(low_res)).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="larger"):
        model(torch.from_numpy(t), torch.from_numpy(x)[:, :4, :4], torch.from_numpy(low_res))


_ENCODER = dict(in_channels=3, model_channels=16, out_channels=5, num_res_blocks=1,
                attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=8,
                use_scale_shift_norm=True)


@pytest.mark.parametrize("pool", ["adaptive", "attention", "spatial", "spatial_v2"])
def test_encoder_unet_matches_flax(pool):
    """Every pool in f32 at 1e-4 of the output's scale; the spatial pools'
    Dense takes the summed channels of every collected feature map."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    t = np.array([0.2, 0.9], np.float32)
    m = junet.EncoderUNetModel(**_ENCODER, pool=pool)
    params = random_flax_params(m, jnp.asarray(t), jnp.asarray(x), seed=12)
    ref = np.asarray(m.apply({"params": params}, jnp.asarray(t), jnp.asarray(x)))
    model = tunet.EncoderUNetModel(**_ENCODER, pool=pool, image_size=8)
    model.load_state_dict(unet_params_from_flax(params), strict=True)
    if pool.startswith("spatial"):
        assert model.Dense_2.weight.shape[1] == 16 + 16 + 16 + 32 + 32  # stem, 3 blocks, middle
    with torch.no_grad():
        out = model(torch.from_numpy(t), torch.from_numpy(x)).numpy()
    assert out.shape == (2, 5) and out.dtype == np.float32
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, atol=1e-4, rtol=1e-4)


def test_encoder_attention_pool_needs_head_channels():
    """JAX asserts ``num_head_channels`` for the attention pool when the
    module first runs; the port refuses it when the module is built."""
    kw = dict(_ENCODER, num_head_channels=-1, num_heads=2, pool="attention")
    with pytest.raises(AssertionError, match="num_head_channels"):
        jax.eval_shape(junet.EncoderUNetModel(**kw).init, jax.random.PRNGKey(0),
                       jnp.zeros((1,)), jnp.zeros((1, 8, 8, 3)))
    with pytest.raises(ValueError, match="num_head_channels"):
        tunet.EncoderUNetModel(**kw, image_size=8)
    with pytest.raises(ValueError, match="Unknown pool"):
        tunet.EncoderUNetModel(**dict(_ENCODER, pool="max"))


@pytest.mark.cuda
def test_imagenet64_32x32_attention_block_takes_the_streamed_route_on_cuda(monkeypatch):
    """An AttentionBlock at ImageNet-64's 32x32 widths (S = 1024, C = 384, 6
    heads of 64) in bf16 on the card: its forward launches #3 and its
    backward #4 once each, on the streamed route, and counts one
    ``attn.streamed_route`` and no ``attn.plain``; its output and its
    gradients agree with the same block on the plain composition within
    3e-2 of each one's max-abs (the bf16 tolerance of the forward tests)."""
    if not torch.cuda.is_available():
        pytest.skip("the attention kernels run only on a CUDA device")
    from cfm_tpu_torch import profiling
    from cfm_tpu_torch.ops import attention as tatt

    g = torch.Generator(device="cuda").manual_seed(0)
    r = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    block = tunet.AttentionBlock(384, num_head_channels=64, dtype=torch.bfloat16).cuda()
    with torch.no_grad():
        block.GroupNorm32_0.weight.copy_(1 + 0.1 * r(384))
        block.GroupNorm32_0.bias.copy_(0.1 * r(384))
        block.qkv_weight.copy_(r(384, 3 * 384) / 384 ** 0.5)
        block.qkv_bias.copy_(0.1 * r(3 * 384))
        block.proj_weight.copy_(r(384, 384) / 384 ** 0.5)
        block.proj_bias.copy_(0.1 * r(384))
    x, dy = r(4, 32, 32, 384).to(torch.bfloat16), r(4, 32, 32, 384).to(torch.bfloat16)

    def run():
        block.zero_grad(set_to_none=True)
        leaf = x.clone().requires_grad_()
        y = block(leaf)
        y.backward(dy)
        return [y, leaf.grad] + [p.grad for p in block.parameters()]

    before = (tatt.attention_t.launches, tatt.attention_t_bwd.launches)
    was = profiling.enable_spans(True)
    profiling.drain()
    try:
        with profiling.span("test.block"):
            got = run()
        torch.cuda.synchronize()
        _, counts = profiling.drain()
    finally:
        profiling.enable_spans(was)
    assert (tatt.attention_t.launches, tatt.attention_t_bwd.launches) == (before[0] + 1,
                                                                            before[1] + 1)
    assert sum(counts["attn.streamed_route"].values()) == 1 and "attn.plain" not in counts
    monkeypatch.setattr(tunet, "attention_t", tatt.attn_reference_t)
    want = run()
    torch.cuda.synchronize()
    assert (tatt.attention_t.launches, tatt.attention_t_bwd.launches) == (before[0] + 1,
                                                                            before[1] + 1)
    for a, b in zip(got, want):
        a, b = a.detach().float().cpu().numpy(), b.detach().float().cpu().numpy()
        scale = np.abs(b).max()
        np.testing.assert_allclose(a / scale, b / scale, atol=3e-2, rtol=3e-2)
