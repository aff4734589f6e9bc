"""The port's attention block (cfm_tpu_torch/ops/attn_block.py) against JAX.

The plain PyTorch version is held against the JAX block kernel run in Pallas
interpret mode on the CPU, at the tolerances the JAX package holds that
kernel to against its composition (f32 2e-4, bf16 3e-2), and against the
JAX composition in f32. The gradients through the port's autograd Function
(the plain backward on CPU tensors) are held against ``jax.vjp`` of the JAX
block, whose backward is the TPU kernel ``_bwd_kernel`` in interpret mode.
The routing gates must agree with JAX's shape and budget conditions. A
torch model of the Hopper forward's attention arithmetic on the block layout
(exp2 logits, the reciprocal of the sum, keys past a ragged S masked, rows
past S dropped) is held against the plain version and the JAX kernel. The
CUDA kernels themselves are checked against the plain versions by the
``cuda``-marked tests, which skip without a card. The JAX package is
imported inside the tests that use it, so that the card-only tests also run
where only PyTorch is installed:
``python -m pytest tests/test_torch_attn_block.py -m cuda -q``.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cfm_tpu_torch.models.unet import gn_groups
from cfm_tpu_torch.ops import attention as tatt
from cfm_tpu_torch.ops import attn_block as tab

_DTYPES = {"f32": ("float32", torch.float32), "bf16": ("bfloat16", torch.bfloat16)}


def _jax(dtype="f32"):
    """The JAX side: jnp, the two Pallas modules and the JAX dtype."""
    import jax.numpy as jnp

    from cfm_tpu.ops import pallas_attention, pallas_attn_block

    return SimpleNamespace(jnp=jnp, pa=pallas_attention, pab=pallas_attn_block,
                           dtype=getattr(jnp, _DTYPES[dtype][0]))


def _inputs(N, S, C, H, seed=0):
    """x (N, S, C) and the flattened block weights, as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(
        x=r(N, S, C),
        gscale=1.0 + 0.1 * r(1, C), gbias=0.1 * r(1, C),
        wq=r(C, 3 * C) / math.sqrt(C), bq=0.1 * r(1, 3 * C),
        wo=0.5 * r(C, C) / math.sqrt(C), bo=0.1 * r(1, C),
    )


def _port(inp, tdtype, H):
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    x = t.pop("x").to(tdtype)
    C = x.shape[-1]
    return tab.fused_attention_block(x, t["gscale"], t["gbias"], t["wq"], t["bq"],
                                     t["wo"], t["bo"], H, gn_groups(C))


@pytest.mark.parametrize("dtype,tol", [("f32", 2e-4), ("bf16", 3e-2)])
@pytest.mark.parametrize("N,S,C,H", [(2, 64, 128, 2), (2, 256, 256, 4)])
def test_plain_matches_jax_kernel_interpret(monkeypatch, N, S, C, H, dtype, tol):
    j = _jax(dtype)
    monkeypatch.setattr(j.pab, "INTERPRET", True)
    tdtype = _DTYPES[dtype][1]
    inp = _inputs(N, S, C, H)
    y_jax = j.pab.fused_attention_block(
        j.jnp.asarray(inp["x"], j.dtype), *(j.jnp.asarray(inp[k]) for k in
                                            ("gscale", "gbias", "wq", "bq", "wo", "bo")),
        H, gn_groups(C))
    y = _port(inp, tdtype, H)
    assert y.dtype == tdtype and y.shape == (N, S, C)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_jax, np.float32),
                               atol=tol, rtol=tol)


def test_plain_matches_jax_composition_f32(monkeypatch):
    """The JAX AttentionBlock's composition path (fused block disabled) on
    the same weights, in f32."""
    from cfm_tpu.models.unet import AttentionBlock

    j = _jax()
    monkeypatch.setattr(j.pab, "ENABLED", False)
    N, hw, C, H = 2, 8, 128, 2
    D = C // H
    inp = _inputs(N, hw * hw, C, H, seed=1)
    params = {
        "GroupNorm32_0": {"scale": inp["gscale"][0], "bias": inp["gbias"][0]},
        "qkv_kernel": inp["wq"].reshape(C, 3, H, D),
        "qkv_bias": inp["bq"].reshape(3, H, D),
        "proj_kernel": inp["wo"].reshape(H, D, C),
        "proj_bias": inp["bo"][0],
    }
    y_jax = AttentionBlock(num_heads=H).apply(
        {"params": params}, j.jnp.asarray(inp["x"].reshape(N, hw, hw, C)))
    y = _port(inp, torch.float32, H)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax).reshape(N, hw * hw, C),
                               atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("S", [16, 56, 64, 256, 1024, 4096])
def test_use_fused_block_agrees_with_jax(monkeypatch, S, dtype):
    j = _jax(dtype)
    monkeypatch.setattr(j.pab, "INTERPRET", True)  # lifts only JAX's backend clause
    tdtype = _DTYPES[dtype][1]
    for C in (64, 96, 128, 256, 384, 512, 1024):
        for H in (1, 2, 3, 4, 8):
            assert tab.use_fused_block(S, C, H, tdtype) == j.pab.use_fused_block(
                S, C, H, j.dtype), (S, C, H, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("S", [16, 64, 128, 256, 1024, 2048])
def test_attention_gate_agrees_with_jax(monkeypatch, S, dtype):
    j = _jax(dtype)
    monkeypatch.setattr(j.pa, "INTERPRET", True)
    tdtype = _DTYPES[dtype][1]
    for H in (1, 2, 4, 8, 16, 32):
        for D in (32, 64, 128):
            assert tatt.gate(H, S, D, tdtype) == j.pa._gate(H, S, D, j.jnp.dtype(j.dtype)), (
                H, S, D)


def test_attention_composition_matches_jax():
    """mid_attn's route: the plain (N, 3, H, S, D) composition, f32 and bf16."""
    rng = np.random.default_rng(2)
    qkv = rng.standard_normal((2, 3, 4, 16, 64)).astype(np.float32)
    for dtype, tol in (("f32", 1e-5), ("bf16", 2e-2)):
        j, tdtype = _jax(dtype), _DTYPES[dtype][1]
        ref = j.pa._attn_reference_t(j.jnp.asarray(qkv, j.dtype), 0.125)
        out = tatt.attention_t(torch.from_numpy(qkv).to(tdtype), 0.125)
        assert out.dtype == tdtype
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                                   atol=tol, rtol=tol)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    inp = _inputs(1, 64, 128, 2, seed=3)
    before = tab.fused_attention_block.launches
    y = _port(inp, torch.float32, 2)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    ref = tab.attention_block_reference(t.pop("x"), *t.values(), 2, 32)
    assert torch.equal(y, ref)
    assert tab.fused_attention_block.launches == before


@pytest.mark.parametrize("bad", ["x_rank", "x_dtype", "wq_shape", "bq_dtype", "heads"])
def test_wrapper_rejects_bad_inputs(bad):
    t = {k: torch.from_numpy(v) for k, v in _inputs(1, 64, 128, 2).items()}
    H, G = 2, 32
    if bad == "x_rank":
        t["x"] = t["x"][0]
    elif bad == "x_dtype":
        t["x"] = t["x"].double()
    elif bad == "wq_shape":
        t["wq"] = t["wq"][:, :-1]
    elif bad == "bq_dtype":
        t["bq"] = t["bq"].to(torch.bfloat16)
    else:
        H = 3
    with pytest.raises((ValueError, TypeError)):
        tab.fused_attention_block(t["x"], t["gscale"], t["gbias"], t["wq"], t["bq"],
                                  t["wo"], t["bo"], H, G)


def test_wrapper_rejects_other_devices():
    t = {k: torch.from_numpy(v).to("meta") for k, v in _inputs(1, 64, 128, 2).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        tab.fused_attention_block(*t.values(), 2, 32)


def test_build_is_keyed_by_source_hash(monkeypatch, tmp_path):
    """The library's name carries the source's hash: an unchanged source is
    built once, an edited one again (nvcc replaced by a script that writes
    its -o file); without nvcc the build raises."""
    from cfm_tpu_torch.ops import _build

    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then shift; echo built > "$1"; fi; shift\ndone\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "_BUILT", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    (csrc / "k.cu").write_text("// v1\n")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("k")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    first = _build.build("k")
    assert first.path.parent == out and first.path.read_text() == "built\n"
    assert _build.build("k") is first
    (csrc / "k.cu").write_text("// v2\n")
    monkeypatch.setattr(_build, "_BUILT", {})
    second = _build.build("k")
    assert second.path != first.path and sorted(p.name for p in out.iterdir()) == sorted(
        [first.path.name, second.path.name])
    monkeypatch.setattr(_build, "_BUILT", {})
    assert _build.build_all() == {"k": _build.Built(second.path, "")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("f32", 1e-4), ("bf16", 2e-2)])
@pytest.mark.parametrize("N,S,C,H", [(4, 64, 256, 4), (8, 256, 256, 4), (4, 72, 128, 2),
                                     (2, 136, 256, 2), (2, 328, 256, 4)])
def test_kernel_matches_plain_on_cuda(N, S, C, H, dtype, tol):
    """Also at ragged S (72 and 136 on the resident attention kernel, 328 on
    the streamed one); the rerun gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("the attention-block kernel runs only on a CUDA device")
    from cfm_tpu_torch.device import strict_f32

    _, tdtype = _DTYPES[dtype]
    t = {k: torch.from_numpy(v).cuda() for k, v in _inputs(N, S, C, H).items()}
    x = t.pop("x").to(tdtype)
    before = tab.fused_attention_block.launches
    with torch.no_grad(), strict_f32():
        y = tab.fused_attention_block(x, *t.values(), H, 32)
        ref = tab.attention_block_reference(x, *t.values(), H, 32)
        again = tab.fused_attention_block(x, *t.values(), H, 32)
    torch.cuda.synchronize()
    assert tab.fused_attention_block.launches == before + 2
    np.testing.assert_allclose(y.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=tol, rtol=tol)
    assert torch.equal(y, again)


# ---------------------------------------------------------------------------
# A model of the Hopper forward (csrc/attn_block_fwd.cu) on the block layout:
# the qkv buffer's rows of an item padded with zeros to 64-row tiles (what
# the rank-3 tensor maps load past S), keys past S masked to -inf, the
# logits' exponentials 2^(acc * scale log2 e - max) with the statistics of
# kernel #3 (one pass at S <= 256, running above), the weights times the
# reciprocal of the sum, and the rows past S dropped (not stored).
# ---------------------------------------------------------------------------


def _model_forward(x, gscale, gbias, wq, bq, wo, bo, H, G):
    from test_torch_attention import _exp, _log2_scale, _stats

    N, S, C = x.shape
    lp, D = x.dtype, C // H
    xs = x.float()
    xg = xs.reshape(N, S, G, C // G)
    centered = xg - xg.mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(centered.square().mean(dim=(1, 3), keepdim=True) + 1e-5)
    tokens = ((centered * rstd).reshape(N, S, C) * gscale + gbias).to(lp)
    qkv = ((tokens.float() @ wq.to(lp).float()).to(lp) + bq.to(lp)).float()
    Sp = 64 * -(-S // 64)
    q, k, v = F.pad(qkv, (0, 0, 0, Sp - S)).reshape(N, Sp, 3, H, D).permute(2, 0, 3, 1, 4)
    acc = q @ k.transpose(-1, -2)
    acc[..., S:] = -math.inf
    ls = _log2_scale(1.0 / math.sqrt(D))
    tiles = acc.split(64, dim=-1)
    m, s = _stats(list(tiles), ls)
    inv = 1.0 / s
    o = sum((_exp(a, ls, m) * inv).to(lp).float() @ vj for a, vj in zip(tiles, v.split(64, -2)))
    ctx = o[:, :, :S].permute(0, 2, 1, 3).reshape(N, S, C).to(lp)
    return (xs + (ctx.float() @ wo.to(lp).float() + bo)).to(lp)


@pytest.mark.parametrize("dtype,tol", [("f32", 2e-4), ("bf16", 3e-2)])
@pytest.mark.parametrize("S", [64, 72, 136, 256])
def test_kernel_model_matches_plain_and_jax_kernel(monkeypatch, S, dtype, tol):
    """The model against the plain version (f32 1e-4, bf16 2e-2 abs+rel: the
    card's limits) and JAX's ``_fwd_kernel`` in interpret mode (the
    tolerances of test_plain_matches_jax_kernel_interpret), at S = 64 and
    256 (whole tiles) and 72 and 136 (ragged: keys past S masked)."""
    j = _jax(dtype)
    monkeypatch.setattr(j.pab, "INTERPRET", True)
    tdtype = _DTYPES[dtype][1]
    N, C, H = 2, 128, 2
    inp = _inputs(N, S, C, H, seed=S)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    x = t.pop("x").to(tdtype)
    got = _model_forward(x, *t.values(), H, 32).float()
    ref = tab.attention_block_reference(x, *t.values(), H, 32).float()
    card_tol = 1e-4 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=card_tol, rtol=card_tol)
    y_jax = j.pab.fused_attention_block(
        j.jnp.asarray(inp["x"], j.dtype), *(j.jnp.asarray(inp[k]) for k in
                                            ("gscale", "gbias", "wq", "bq", "wo", "bo")), H, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(y_jax, np.float32), atol=tol, rtol=tol)


def test_block_exp2_weights_equal_direct_softmax_but_at_ties():
    """On the block layout at ragged S = 136 (keys 136..191 of the third
    tile masked), the bf16 weights of the Hopper kernel's arithmetic equal
    those of the plain version's exp(l - max) / sum(e) except where the two
    f32 values straddle a bf16 rounding boundary, one bf16 step apart: at
    this seed 4 of 147,968 weights (N = 2, H = 4)."""
    from test_torch_attention import _exp, _log2_scale, _stats

    N, S, H, D = 2, 136, 4, 64
    rng = np.random.default_rng(12)
    qk = torch.from_numpy(rng.standard_normal((2, N, H, S, D)).astype(np.float32))
    q, k = qk.to(torch.bfloat16).float()
    scale = 1.0 / math.sqrt(D)
    logits = (q @ k.transpose(-1, -2)) * scale
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    direct = (e / e.sum(-1, keepdim=True)).to(torch.bfloat16)
    acc = F.pad(q @ k.transpose(-1, -2), (0, 192 - S), value=-math.inf)
    ls = _log2_scale(scale)
    tiles = acc.split(64, dim=-1)
    m, s = _stats(list(tiles), ls)
    kernel = torch.cat([_exp(a, ls, m) for a in tiles], -1) * (1.0 / s)
    assert (kernel[..., S:] == 0).all()
    kernel = kernel[..., :S].to(torch.bfloat16)
    differ = direct != kernel
    assert differ.sum().item() == 4
    bits = (direct[differ].view(torch.int16).int() - kernel[differ].view(torch.int16).int()).abs()
    assert (bits == 1).all()


_GRADS = ("dx", "dgscale", "dgbias", "dwq", "dbq", "dwo", "dbo")


def _port_grads(inp, dy, tdtype, H):
    """Gradients through the port's autograd Function on CPU tensors."""
    x = torch.from_numpy(inp["x"]).to(tdtype).requires_grad_()
    w = [torch.from_numpy(inp[k]).requires_grad_()
         for k in ("gscale", "gbias", "wq", "bq", "wo", "bo")]
    y = tab.fused_attention_block(x, *w, H, gn_groups(x.shape[-1]))
    y.backward(torch.from_numpy(dy).to(tdtype))
    return [x.grad] + [t.grad for t in w]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("N,S,C,H", [(2, 64, 128, 2), (2, 256, 256, 4)])
def test_backward_matches_jax_vjp_interpret(monkeypatch, N, S, C, H, dtype):
    """f32 at 2e-4 of each gradient's max-abs. bf16: dx at 2e-2 (one bf16
    rounding step of an output up to about 4, where the two accumulation
    orders round a qkv or dqkv element apart), the f32 weight gradients at
    5e-3 of their max-abs (sums over N*S rows of products of bf16 operands
    that round apart the same way)."""
    import jax

    j = _jax(dtype)
    monkeypatch.setattr(j.pab, "INTERPRET", True)
    inp = _inputs(N, S, C, H)
    dy = np.random.default_rng(7).standard_normal((N, S, C)).astype(np.float32)
    args = [j.jnp.asarray(inp["x"], j.dtype)] + [
        j.jnp.asarray(inp[k]) for k in ("gscale", "gbias", "wq", "bq", "wo", "bo")]
    _, vjp = jax.vjp(lambda *a: j.pab.fused_attention_block(*a, H, gn_groups(C)), *args)
    ref = vjp(j.jnp.asarray(dy, j.dtype))
    out = _port_grads(inp, dy, _DTYPES[dtype][1], H)
    for name, o, r in zip(_GRADS, out, ref):
        r = np.asarray(r, np.float32)
        assert o.shape == r.shape, name
        tol = 2e-4 if dtype == "f32" else (2e-2 if name == "dx" else 5e-3)
        scale = 1.0 if name == "dx" and dtype == "bf16" else np.abs(r).max()
        np.testing.assert_allclose(o.float().numpy() / scale, r / scale, atol=tol, rtol=tol,
                                   err_msg=name)


def test_autograd_backward_on_cpu_is_the_plain_backward():
    """The Function's backward is the transcription of ``_bwd_kernel``, not
    autograd of the plain forward, and counts no launch."""
    inp = _inputs(2, 64, 128, 2, seed=8)
    dy = np.random.default_rng(9).standard_normal((2, 64, 128)).astype(np.float32)
    before = tab.fused_attention_block_bwd.launches
    got = _port_grads(inp, dy, torch.bfloat16, 2)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    ref = tab.attention_block_backward_reference(
        t.pop("x").to(torch.bfloat16), *t.values(), torch.from_numpy(dy).to(torch.bfloat16),
        2, 32)
    for name, g, r in zip(_GRADS, got, ref):
        assert torch.equal(g, r), name
    assert tab.fused_attention_block_bwd.launches == before


def test_backward_reference_with_do_ds_rounded_falls_outside_the_bf16_limit():
    """Rounding do and ds to bf16 leaves dwo and dbo as they were and moves
    the gradients behind them by more than the 1e-3 of max-abs to which the
    card holds the bf16 backward kernel."""
    inp = _inputs(4, 64, 128, 2, seed=10)
    dy = np.random.default_rng(11).standard_normal((4, 64, 128)).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    args = [t.pop("x").to(torch.bfloat16), *t.values(), torch.from_numpy(dy).to(torch.bfloat16),
            2, 32]
    ref = tab.attention_block_backward_reference(*args)
    rounded = tab.attention_block_backward_reference(*args, round_do_ds=True)
    moved = {n: ((o - r).abs().max() / r.abs().max()).item()
             for n, o, r in zip(_GRADS[1:], rounded[1:], ref[1:])}
    assert moved["dwo"] == moved["dbo"] == 0.0
    assert min(moved[n] for n in ("dgscale", "dgbias", "dwq", "dbq")) > 1e-3, moved


def test_backward_wrapper_rejects_a_mismatched_dy():
    t = {k: torch.from_numpy(v) for k, v in _inputs(1, 64, 128, 2).items()}
    x = t.pop("x")
    with pytest.raises(ValueError, match="dy must match"):
        tab.fused_attention_block_bwd(x, *t.values(), x.to(torch.bfloat16), 2, 32)


# ---------------------------------------------------------------------------
# A torch model of the fused bf16 backward (csrc/attn_block_bwd.cu): the
# GroupNorm strip's statistics (mean, then the centred variance, 1 / sqrt),
# #1's qkv and #3's exp2 weights on the block layout (keys past a ragged S
# masked), dattn in f32 split exactly into three bf16 parts, dp and dv as
# three products of those parts, dw = dp - rowsum(dp * w), ds split in three
# for dq and dk, dbq from the f32 dqkv, the weight products from T(dqkv),
# and the GroupNorm backward from per-channel sums and the strip's means.
# ---------------------------------------------------------------------------


def _split3(x):
    """f32 x as bf16 hi + mid + lo, each step rounded to nearest, as
    to_split_frags and the dattn epilogue split it."""
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    return hi, mid, (x - hi - mid).to(torch.bfloat16).float()


def _model_backward(x, gscale, gbias, wq, bq, wo, bo, dy, H, G):
    from test_torch_attention import _exp, _log2_scale, _stats

    N, S, C = x.shape
    lp, D, cg = x.dtype, C // H, C // G
    scale = 1.0 / math.sqrt(D)
    rows = lambda t: t.reshape(N * S, -1)
    xs, dyf = x.float(), dy.float()
    xg = xs.reshape(N, S, G, cg)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    inv = 1.0 / torch.sqrt((xg - mean).square().mean(dim=(1, 3), keepdim=True) + 1e-5)
    inv_c = inv.expand_as(xg).reshape(N, S, C)
    xh = (xg - mean).reshape(N, S, C) * inv_c
    tokens = (xh * gscale + gbias).to(lp).float()
    wq_b, wo_b = wq.to(lp).float(), wo.to(lp).float()
    qkv = ((tokens @ wq_b).to(lp) + bq.to(lp)).float()
    Sp = 64 * -(-S // 64)
    heads = lambda t, k: F.pad(t, (0, 0, 0, Sp - S)).reshape(N, Sp, k, H, D).permute(2, 0, 3, 1, 4)
    q, k, v = heads(qkv, 3)
    acc = q @ k.transpose(-1, -2)
    acc[..., S:] = -math.inf                     # keys past S
    ls = _log2_scale(scale)
    tiles = acc.split(64, dim=-1)
    m, s = _stats(list(tiles), ls)
    wf = torch.cat([_exp(a, ls, m) for a in tiles], -1) * (1.0 / s)
    w = wf.to(lp).float()
    attn = (w @ v)[:, :, :S].permute(0, 2, 1, 3).reshape(N, S, C).to(lp).float()
    do = [heads(p, 1)[0] for p in _split3(dyf @ wo_b.T)]   # dattn = hi + mid + lo
    dp = sum(p @ v.transpose(-1, -2) for p in do)
    ds = (wf * (dp - (dp * w).sum(-1, keepdim=True))) * scale
    dq = sum(p @ k for p in _split3(ds))
    queries = (torch.arange(Sp) < S)[:, None].float()   # the columns kernel masks queries past S
    wq_t, ds_t = (w * queries).transpose(-1, -2), (ds * queries).transpose(-1, -2)
    dk = sum(p @ q for p in _split3(ds_t))
    dv = sum(wq_t @ p for p in do)
    dqkv = torch.stack([dq, dk, dv])[:, :, :, :S].permute(1, 3, 0, 2, 4).reshape(N, S, 3 * C)
    dbq = dqkv.sum(dim=(0, 1))
    dqkv_b = dqkv.to(lp).float()
    dwo = rows(attn).T @ rows(dyf)
    dwq = rows(tokens).T @ rows(dqkv_b)
    dt = dqkv_b @ wq_b.T
    s1, s2 = dt.sum(1), (dt * xh).sum(1)           # (N, C): dgbias and dgscale per item
    group = lambda t: (gscale[0] * t).reshape(N, 1, G, cg).sum(-1, keepdim=True).expand(
        N, 1, G, cg).reshape(N, 1, C) / (S * cg)
    dx = (dyf + inv_c * ((dt * gscale - group(s1)) - xh * group(s2))).to(lp)
    return (dx, s2.sum(0)[None], s1.sum(0)[None], dwq, dbq[None], dwo, dyf.sum(dim=(0, 1))[None])


def test_split_of_do_and_ds_is_exact():
    """f32 do and ds split into bf16 hi + mid + lo bit for bit, each part a
    bf16 value, for every magnitude from 2^-110 to 2^100 and zero; below
    2^-110 the lowest part can fall under bf16's smallest subnormal (2^-133),
    and what is lost is at most half of it. The three products of the parts
    equal the f32 product to f32 accumulation rounding; rounding do once to
    bf16 does not."""
    rng = np.random.default_rng(13)
    mag = lambda lo, hi, k: (rng.choice([-1.0, 1.0], k) * (1.0 + rng.random(k))
                             * np.exp2(rng.integers(lo, hi, k))).astype(np.float32)
    x = mag(-110, 100, 1 << 16)
    x[:64] = 0.0
    t = torch.from_numpy(x)
    parts = _split3(t)
    for part in parts:
        assert torch.equal(part.to(torch.bfloat16).float(), part)
    hi, mid, lo = parts
    assert torch.equal((hi + mid) + lo, t) and torch.equal(hi + (mid + lo), t)
    tiny = torch.from_numpy(mag(-126, -110, 4096))
    hi, mid, lo = _split3(tiny)
    assert ((hi + mid + lo - tiny).abs() <= 2.0 ** -134).all()
    dom = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32) * 1e-2)
    v = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32))
    v = v.to(torch.bfloat16).float()
    exact = dom.double() @ v.double().T
    bound = 64 * torch.finfo(torch.float32).eps * (dom.abs().double() @ v.abs().double().T)
    split = sum(p @ v.T for p in _split3(dom))
    assert ((split.double() - exact).abs() <= bound).all()
    assert ((dom.to(torch.bfloat16).float() @ v.T).double() - exact).abs().gt(bound).any()


@pytest.mark.parametrize("dtype,tol", [("f32", 2e-4), ("bf16", 3e-2)])
@pytest.mark.parametrize("S", [64, 72])
def test_fused_backward_model_matches_plain_and_jax_kernel(monkeypatch, S, dtype, tol):
    """The model against the plain backward at the card's limits (dx f32
    1e-4, bf16 2e-2 abs+rel; the weight gradients 1e-4, 1e-3 of their
    max-abs) and against jax.vjp of the JAX block, whose backward is
    ``_bwd_kernel`` in interpret mode (dx at ``tol``; the weight gradients
    at 1e-4 / 1e-3 of their max-abs in f32 / bf16), at a whole key tile and
    a ragged one (S = 72: keys past S masked)."""
    import jax

    j = _jax(dtype)
    monkeypatch.setattr(j.pab, "INTERPRET", True)
    tdtype = _DTYPES[dtype][1]
    N, C, H, G = 2, 128, 2, 32
    inp = _inputs(N, S, C, H, seed=S + 1)
    dy = np.random.default_rng(S).standard_normal((N, S, C)).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    x = t.pop("x").to(tdtype)
    tdy = torch.from_numpy(dy).to(tdtype)
    got = _model_backward(x, *t.values(), tdy, H, G)
    ref = tab.attention_block_backward_reference(x, *t.values(), tdy, H, G)
    args = [j.jnp.asarray(inp["x"], j.dtype)] + [
        j.jnp.asarray(inp[k]) for k in ("gscale", "gbias", "wq", "bq", "wo", "bo")]
    _, vjp = jax.vjp(lambda *a: j.pab.fused_attention_block(*a, H, G), *args)
    jref = vjp(j.jnp.asarray(dy, j.dtype))
    card = 1e-4 if dtype == "f32" else 2e-2
    wcard = 1e-4 if dtype == "f32" else 1e-3
    for name, g, r, jr in zip(_GRADS, got, ref, jref):
        g, r, jr = g.float().numpy(), r.float().numpy(), np.asarray(jr, np.float32)
        assert g.shape == r.shape == jr.shape, name
        if name == "dx":
            np.testing.assert_allclose(g, r, atol=card, rtol=card, err_msg=name)
            np.testing.assert_allclose(g, jr, atol=tol, rtol=tol, err_msg=name)
        else:
            assert np.abs(g - r).max() <= wcard * np.abs(r).max(), name
            assert np.abs(g - jr).max() <= wcard * np.abs(jr).max(), name


@pytest.mark.cuda
@pytest.mark.parametrize("N,S,C,H", [(4, 72, 128, 2), (2, 136, 256, 4), (2, 72, 256, 2)])
def test_fused_backward_kernel_at_ragged_s_on_cuda(N, S, C, H):
    """The fused bf16 route at a ragged S (D = 64 and 128): one launch of
    the wrapper, the plain version's gradients at the card's limits (dx 2e-2
    abs+rel, weight gradients 1e-3 of their max-abs), and a rerun giving the
    same bits."""
    if not torch.cuda.is_available():
        pytest.skip("the attention-block backward kernel runs only on a CUDA device")
    t = {k: torch.from_numpy(v).cuda() for k, v in _inputs(N, S, C, H, seed=3).items()}
    x = t.pop("x").to(torch.bfloat16)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)).cuda().to(torch.bfloat16)
    assert tab._lib_bwd().attn_block_bwd_fused(C, H, 32, 1) == 1
    before = tab.fused_attention_block_bwd.launches
    out = tab.fused_attention_block_bwd(x, *t.values(), dy, H, 32)
    again = tab.fused_attention_block_bwd(x, *t.values(), dy, H, 32)
    ref = tab.attention_block_backward_reference(x, *t.values(), dy, H, 32)
    torch.cuda.synchronize()
    assert tab.fused_attention_block_bwd.launches == before + 2
    for name, o, a, r in zip(_GRADS, out, again, ref):
        assert torch.equal(o, a), name
        o, r = o.float().cpu().numpy(), r.float().cpu().numpy()
        if name == "dx":
            np.testing.assert_allclose(o, r, atol=2e-2, rtol=2e-2, err_msg=name)
        else:
            assert np.abs(o - r).max() <= 1e-3 * np.abs(r).max(), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("f32", 1e-4), ("bf16", 2e-2)])
@pytest.mark.parametrize("N,S,C,H", [(4, 64, 256, 4), (8, 256, 256, 4), (4, 72, 128, 2)])
def test_backward_kernel_matches_plain_on_cuda(N, S, C, H, dtype, tol):
    """dx element-wise abs+rel; the weight gradients relative to their max-abs,
    at ``tol`` in f32 and 1e-3 in bf16. The bf16 kernel reads up to 5.8e-4
    there, and the backward with do and ds rounded to bf16 (what feeding them
    to bf16 tensor cores would do) 1.4e-3 or more, so the limit catches it."""
    if not torch.cuda.is_available():
        pytest.skip("the attention-block backward kernel runs only on a CUDA device")
    from cfm_tpu_torch.device import strict_f32

    _, tdtype = _DTYPES[dtype]
    t = {k: torch.from_numpy(v).cuda() for k, v in _inputs(N, S, C, H).items()}
    x = t.pop("x").to(tdtype)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)).cuda().to(tdtype)
    before = tab.fused_attention_block_bwd.launches
    with strict_f32():
        out = tab.fused_attention_block_bwd(x, *t.values(), dy, H, 32)
        ref = tab.attention_block_backward_reference(x, *t.values(), dy, H, 32)
    torch.cuda.synchronize()
    assert tab.fused_attention_block_bwd.launches == before + 1
    for name, o, r in zip(_GRADS, out, ref):
        o, r = o.float().cpu().numpy(), r.float().cpu().numpy()
        if name == "dx":
            np.testing.assert_allclose(o, r, atol=tol, rtol=tol, err_msg=name)
        else:
            limit = 1e-3 if dtype == "bf16" else tol
            assert np.abs(o - r).max() <= limit * np.abs(r).max(), name
