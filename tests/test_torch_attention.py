"""The port's multi-head attention (cfm_tpu_torch/ops/attention.py, kernels #3
and #4) against JAX.

The plain forward is held against the JAX kernel ``_fwd_kernel`` run in
Pallas interpret mode on the CPU, through both ``fused_attention_t`` and the
(N, S, 3, H, D) ``fused_attention``; the plain backward against ``jax.vjp``
of the same, whose backward is ``_bwd_kernel`` in interpret mode. float32
within 1e-5 of the output's max-abs (summation order only); bfloat16 within
one bf16 rounding step (both sides round the same float32 value, whose two
summation orders may straddle a rounding boundary). The routing gate must
equal JAX's ``_gate``; shapes it refuses take the plain composition, except
in bf16 on CUDA where ``streamed_route`` admits them. The CUDA kernels are
held against the plain versions by the ``cuda``-marked tests, which skip without a card; the JAX package is
imported inside the tests that use it, so those also run where only PyTorch
is installed: ``python -m pytest tests/test_torch_attention.py -m cuda -q``.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cfm_tpu_torch.ops import attention as tatt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU work: the suite runs six
    workers on the machine's cores, and torch's OpenMP pool of one thread a
    core then waits on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_DTYPES = {"f32": ("float32", torch.float32), "bf16": ("bfloat16", torch.bfloat16)}
SHAPES = [(2, 3, 256, 64), (2, 1, 128, 128)]  # (N, H, S, D), both pass the gate


def _jax(dtype="f32"):
    import jax
    import jax.numpy as jnp

    from cfm_tpu.ops import pallas_attention

    return SimpleNamespace(jax=jax, jnp=jnp, pa=pallas_attention,
                           dtype=getattr(jnp, _DTYPES[dtype][0]))


def _qkv_t(N, H, S, D, seed=0):
    return np.random.default_rng(seed).standard_normal((N, 3, H, S, D)).astype(np.float32)


def bf16_step(ref):
    """One bf16 rounding step at the output's largest magnitude: the spacing
    of bf16 numbers there. Both sides round the same float32 sums, and a
    softmax weight whose two float32 values straddle a bf16 boundary rounds
    one step apart, which moves its row of the output by that step of the
    weight times v."""
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _assert_close(out, ref, dtype):
    out, ref = out.float().numpy(), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    if dtype == "f32":
        scale = np.abs(ref).max()
        np.testing.assert_allclose(out / scale, ref / scale, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(out, ref, atol=bf16_step(ref), rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("N,H,S,D", SHAPES)
def test_forward_matches_jax_kernel_interpret(monkeypatch, N, H, S, D, dtype):
    j = _jax(dtype)
    monkeypatch.setattr(j.pa, "INTERPRET", True)
    tdtype = _DTYPES[dtype][1]
    qkv_t = _qkv_t(N, H, S, D)
    scale = 1.0 / math.sqrt(D)
    ref_t = j.pa.fused_attention_t(j.jnp.asarray(qkv_t, j.dtype), scale)
    ref = j.pa.fused_attention(j.jnp.asarray(qkv_t.transpose(0, 3, 1, 2, 4), j.dtype), scale)
    before = tatt.attention_t.launches
    out_t = tatt.attention_t(torch.from_numpy(qkv_t).to(tdtype), scale)
    out = tatt.attention(torch.from_numpy(qkv_t.transpose(0, 3, 1, 2, 4)).to(tdtype), scale)
    assert out_t.dtype == tdtype and out_t.shape == (N, H, S, D)
    assert tatt.attention_t.launches == before
    _assert_close(out_t, ref_t, dtype)
    _assert_close(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("N,H,S,D", SHAPES)
def test_backward_matches_jax_vjp_interpret(monkeypatch, N, H, S, D, dtype):
    j = _jax(dtype)
    monkeypatch.setattr(j.pa, "INTERPRET", True)
    tdtype = _DTYPES[dtype][1]
    qkv_t = _qkv_t(N, H, S, D, seed=1)
    do = np.random.default_rng(2).standard_normal((N, H, S, D)).astype(np.float32)
    scale = 1.0 / math.sqrt(D)
    _, vjp = j.jax.vjp(lambda a: j.pa.fused_attention_t(a, scale),
                       j.jnp.asarray(qkv_t, j.dtype))
    ref = vjp(j.jnp.asarray(do, j.dtype))[0]
    out = tatt.attention_t_bwd(torch.from_numpy(qkv_t).to(tdtype),
                               torch.from_numpy(do).to(tdtype), scale)
    assert out.dtype == tdtype
    _assert_close(out, ref, dtype)


_IMAGENET64 = [(12, 64, 64), (9, 256, 64), (6, 1024, 64)]  # (H, S, D) at 8x8, 16x16, 32x32


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gate_agrees_with_jax_on_imagenet64_shapes(monkeypatch, dtype):
    """The port's gate equals JAX's ``_gate`` (its backend clause lifted by
    interpret mode) on a grid that holds the three attention shapes of the
    ImageNet-64 UNet; of those only the 16x16 blocks pass, in both dtypes."""
    j = _jax(dtype)
    monkeypatch.setattr(j.pa, "INTERPRET", True)
    tdtype = _DTYPES[dtype][1]
    grid = [(H, S, D) for H in (1, 2, 6, 9, 12, 16) for S in (64, 128, 256, 384, 512, 896, 1024)
            for D in (32, 64, 128)]
    for H, S, D in grid + _IMAGENET64:
        assert tatt.gate(H, S, D, tdtype) == j.pa._gate(H, S, D, j.jnp.dtype(j.dtype)), (H, S, D)
    assert [tatt.gate(H, S, D, tdtype) for H, S, D in _IMAGENET64] == [False, True, False]


def test_autograd_backward_on_cpu_is_the_plain_backward():
    """At a gated shape the gradient through :func:`attention_t` is the
    transcription of ``_bwd_kernel``, not autograd of the plain forward, and
    counts no launch; at a shape the gate refuses it is autograd of the
    plain composition, as in the JAX package."""
    qkv_t = torch.from_numpy(_qkv_t(2, 2, 128, 64, seed=3)).to(torch.bfloat16)
    do = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 2, 128, 64))
                          .astype(np.float32)).to(torch.bfloat16)
    before = (tatt.attention_t.launches, tatt.attention_t_bwd.launches)
    leaf = qkv_t.clone().requires_grad_()
    tatt.attention_t(leaf, 0.125).backward(do)
    assert torch.equal(leaf.grad, tatt.attention_t_bwd_reference(qkv_t, do, 0.125))
    auto = qkv_t.clone().requires_grad_()
    tatt.attn_reference_t(auto, 0.125).backward(do)
    assert not torch.equal(auto.grad, leaf.grad)
    assert (tatt.attention_t.launches, tatt.attention_t_bwd.launches) == before
    small = qkv_t[:, :, :, :16].clone().requires_grad_()   # S = 16: refused
    tatt.attention_t(small, 0.125).backward(do[:, :, :16])
    ref = qkv_t[:, :, :, :16].clone().requires_grad_()
    tatt.attn_reference_t(ref, 0.125).backward(do[:, :, :16])
    assert torch.equal(small.grad, ref.grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streamed_route_admits_bf16_tensor_core_shapes_beyond_the_gate(dtype):
    """The CUDA-only predicate: bf16 at head dims 64 and 128 with S a
    multiple of 64 above 256 (where the kernels stream K and V); never
    float32. The ImageNet-64 32x32 blocks, which the gate refuses, take it
    in bf16."""
    for S in (64, 200, 256, 320, 384, 896, 1000, 1024, 2048):
        for D in (32, 64, 128, 192):
            want = dtype == torch.bfloat16 and D in (64, 128) and S % 64 == 0 and S > 256
            assert tatt.streamed_route(S, D, dtype) == want, (S, D)
    assert not tatt.gate(6, 1024, 64, dtype)
    assert tatt.streamed_route(1024, 64, dtype) == (dtype == torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_keeps_the_plain_composition_beyond_the_gate(dtype):
    """On the CPU a shape the gate refuses takes the plain composition with
    autograd through it, as in the JAX package, whatever ``streamed_route``
    says: the same bits as :func:`attn_reference_t` forward and backward, no
    launch, and neither route counter (they count CUDA calls)."""
    from cfm_tpu_torch import profiling

    N, H, S, D = 1, 2, 1024, 64
    qkv_t = torch.from_numpy(_qkv_t(N, H, S, D, seed=5)).to(dtype)
    do = torch.from_numpy(np.random.default_rng(6).standard_normal((N, H, S, D))
                          .astype(np.float32)).to(dtype)
    assert not tatt.gate(H, S, D, dtype)
    before = (tatt.attention_t.launches, tatt.attention_t_bwd.launches)
    leaf = qkv_t.clone().requires_grad_()
    was = profiling.enable_spans(True)
    profiling.drain()
    try:
        with profiling.span("test.attention"):
            out = tatt.attention_t(leaf, 0.125)
        _, counts = profiling.drain()
    finally:
        profiling.enable_spans(was)
    out.backward(do)
    ref_leaf = qkv_t.clone().requires_grad_()
    ref = tatt.attn_reference_t(ref_leaf, 0.125)
    ref.backward(do)
    assert torch.equal(out, ref) and torch.equal(leaf.grad, ref_leaf.grad)
    assert (tatt.attention_t.launches, tatt.attention_t_bwd.launches) == before
    assert "attn.streamed_route" not in counts and "attn.plain" not in counts


def test_wrappers_reject_bad_inputs():
    qkv_t = torch.zeros(1, 3, 1, 128, 64)
    with pytest.raises(ValueError, match="N, 3, H, S, D"):
        tatt.attention_t(qkv_t[:, :2], 0.125)
    with pytest.raises(ValueError, match="do must be"):
        tatt.attention_t_bwd(qkv_t, torch.zeros(1, 1, 128, 64, dtype=torch.bfloat16), 0.125)
    with pytest.raises(ValueError, match="unsupported device"):
        tatt.attention_t(qkv_t.to("meta"), 0.125)


def _card_inputs(N, H, S, D, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv_t = torch.randn((N, 3, H, S, D), generator=g, device="cuda").to(dtype)
    do = torch.randn((N, H, S, D), generator=g, device="cuda").to(dtype)
    return qkv_t, do


# Then the gate's edges, which take the two-pass routes, an odd number of
# tiles there, and four shapes
# beyond the gate that take them in bf16 through ``streamed_route`` (the
# ImageNet-64 32x32 blocks' heads, D = 128, a longer S, an odd tile count).
_CARD_SHAPES = [(4, 1, 128, 64), (2, 2, 512, 64), (8, 9, 256, 64), (2, 2, 256, 128),
                (2, 2, 896, 64), (1, 1, 768, 128), (2, 2, 576, 64), (4, 6, 1024, 64),
                (2, 2, 1024, 128), (1, 2, 2048, 64), (1, 2, 1088, 64)]


def _on_kernels(H, S, D, dtype):
    """Whether a CUDA call of :func:`attention_t` runs the kernels."""
    return tatt.gate(H, S, D, dtype) or tatt.streamed_route(S, D, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("f32", 1e-4), ("bf16", 2e-2)])
@pytest.mark.parametrize("N,H,S,D", _CARD_SHAPES)
def test_forward_kernel_matches_plain_on_cuda(N, H, S, D, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("the attention kernel runs only on a CUDA device")
    from cfm_tpu_torch.device import strict_f32

    qkv_t, _ = _card_inputs(N, H, S, D, _DTYPES[dtype][1])
    gated = _on_kernels(H, S, D, qkv_t.dtype)  # in bf16 only from S = 896
    before = tatt.attention_t.launches
    with torch.no_grad(), strict_f32():
        out = tatt.attention_t(qkv_t, 1.0 / math.sqrt(D))
        ref = tatt.attn_reference_t(qkv_t, 1.0 / math.sqrt(D))
    torch.cuda.synchronize()
    assert tatt.attention_t.launches == before + int(gated)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("f32", 1e-4), ("bf16", 2e-2)])
@pytest.mark.parametrize("N,H,S,D", _CARD_SHAPES)
def test_backward_kernel_matches_plain_on_cuda(N, H, S, D, dtype, tol):
    """Through the autograd Function: the gradient launches the backward
    kernel once and agrees with the plain backward element-wise, abs+rel."""
    if not torch.cuda.is_available():
        pytest.skip("the attention backward kernel runs only on a CUDA device")
    from cfm_tpu_torch.device import strict_f32

    qkv_t, do = _card_inputs(N, H, S, D, _DTYPES[dtype][1], seed=1)
    gated = _on_kernels(H, S, D, qkv_t.dtype)
    leaf = qkv_t.clone().requires_grad_()
    before = tatt.attention_t_bwd.launches
    with strict_f32():
        tatt.attention_t(leaf, 1.0 / math.sqrt(D)).backward(do)
        if gated:
            ref = tatt.attention_t_bwd_reference(qkv_t, do, 1.0 / math.sqrt(D))
        else:  # the plain composition with autograd, as in the JAX package
            plain = qkv_t.clone().requires_grad_()
            tatt.attn_reference_t(plain, 1.0 / math.sqrt(D)).backward(do)
            ref = plain.grad
    torch.cuda.synchronize()
    assert tatt.attention_t_bwd.launches == before + int(gated)
    np.testing.assert_allclose(leaf.grad.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,S,D", _CARD_SHAPES)
def test_forward_kernel_rerun_gives_the_same_bits_on_cuda(N, H, S, D):
    """The bf16 forward (every card shape takes the kernels in bf16) sums in
    a fixed order: a second call on the same inputs gives the same bits, and
    both launch the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("the attention kernel runs only on a CUDA device")
    qkv_t, _ = _card_inputs(N, H, S, D, torch.bfloat16, seed=3)
    before = tatt.attention_t.launches
    with torch.no_grad():
        first = tatt.attention_t(qkv_t, 1.0 / math.sqrt(D))
        second = tatt.attention_t(qkv_t, 1.0 / math.sqrt(D))
    torch.cuda.synchronize()
    assert tatt.attention_t.launches == before + 2
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,S,D", _CARD_SHAPES)
def test_backward_kernel_rerun_gives_the_same_bits_on_cuda(N, H, S, D):
    """The bf16 backward has no atomics and no order that changes between
    runs: a second call on the same inputs gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("the attention backward kernel runs only on a CUDA device")
    qkv_t, do = _card_inputs(N, H, S, D, torch.bfloat16, seed=2)
    first = tatt.attention_t_bwd(qkv_t, do, 1.0 / math.sqrt(D))
    second = tatt.attention_t_bwd(qkv_t, do, 1.0 / math.sqrt(D))
    torch.cuda.synchronize()
    assert torch.equal(first, second)

@pytest.mark.cuda
@pytest.mark.parametrize("N,H,S,D", [sh for sh in _CARD_SHAPES if sh[2] > 256])
def test_backward_from_the_forwards_statistics_gives_the_same_bits_on_cuda(N, H, S, D):
    """Above S = 256 the forward kernel keeps the rows' max and sum and the
    backward's rows kernel takes them in place of its pass 0: dqkv has the
    same bits with and without them, and the autograd Function, which passes
    them, gives those bits too."""
    if not torch.cuda.is_available():
        pytest.skip("the attention kernels run only on a CUDA device")
    qkv_t, do = _card_inputs(N, H, S, D, torch.bfloat16, seed=4)
    scale = 1.0 / math.sqrt(D)
    saved = torch.full((2, N, H, S), float("nan"), device="cuda")
    with torch.no_grad():
        out = tatt._forward(qkv_t, scale, saved)
        plain_out = tatt._forward(qkv_t, scale)
    with_saved = tatt.attention_t_bwd(qkv_t, do, scale, saved)
    without = tatt.attention_t_bwd(qkv_t, do, scale)
    leaf = qkv_t.clone().requires_grad_()
    tatt.attention_t(leaf, scale).backward(do)
    torch.cuda.synchronize()
    assert torch.isfinite(saved).all()
    assert torch.equal(out, plain_out)
    assert torch.equal(with_saved, without) and torch.equal(leaf.grad, without)
    with pytest.raises(ValueError, match="saved must be"):
        tatt.attention_t_bwd(qkv_t, do, scale, saved[:, :, :, :64])


# ---------------------------------------------------------------------------
# A torch model of the Hopper kernels' tiling (csrc/attention_fwd.cu,
# csrc/attention_bwd.cu), run on the CPU: 64-key and 64-query tiles, the
# one-pass exact softmax at S <= 256 and the rescaled running sum above, the
# exponentials 2^(acc * scale log2 e - max) with the row max taken on
# acc = q . k and scaled once, the weights as those times the reciprocal of
# the sum, delta taken directly, the (A)/(B) split of the backward with its
# row statistics, and dq and dk as three bf16 products of the split ds.
# ---------------------------------------------------------------------------

_TILE = 64


def _tiles(x, dim=-2):
    return x.split(_TILE, dim=dim)


def _log2_scale(scale):
    return torch.tensor(scale, dtype=torch.float32) * torch.tensor(math.log2(math.e),
                                                                     dtype=torch.float32)


def _exp(acc, ls, m):
    """2^(acc * ls - m) with the multiply-add rounded once, as fmaf does."""
    return torch.exp2((acc.double() * ls.double() - m.double()).float())


def _row_max(acc, ls):
    return acc.amax(-1, keepdim=True) * ls


def _running_stats(acc_tiles, ls):
    """Row max and rescaled running sum over key tiles (the two-pass route)."""
    m = torch.full(acc_tiles[0].shape[:-1] + (1,), -math.inf)
    s = torch.zeros_like(m)
    for a in acc_tiles:
        new = torch.maximum(m, _row_max(a, ls))
        s = s * torch.exp2(m - new) + _exp(a, ls, new).sum(-1, keepdim=True)
        m = new
    return m, s


def _stats(acc_tiles, ls):
    """The row statistics: exact in one pass at S <= 256, else running."""
    if len(acc_tiles) <= 4:
        m = _row_max(torch.cat(acc_tiles, -1), ls)
        return m, sum(_exp(a, ls, m).sum(-1, keepdim=True) for a in acc_tiles)
    return _running_stats(acc_tiles, ls)


def _model_forward(qkv_t, scale):
    lp, ls = qkv_t.dtype, _log2_scale(scale)
    q, k, v = qkv_t.float().unbind(1)
    acc = [q @ kj.transpose(-1, -2) for kj in _tiles(k)]
    m, s = _stats(acc, ls)
    inv = 1.0 / s
    o = torch.zeros_like(q)
    for a, vj in zip(acc, _tiles(v)):
        o = o + (_exp(a, ls, m) * inv).to(lp).float() @ vj
    return o.to(lp)


def _split(x):
    """f32 x as bf16-valued hi + mid + lo (exact)."""
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    return hi, mid, x - hi - mid


def _split_product(x, b):
    hi, mid, lo = _split(x)
    return hi @ b + mid @ b + lo @ b


def _model_backward(qkv_t, do, scale):
    lp, ls = qkv_t.dtype, _log2_scale(scale)
    q, k, v = qkv_t.float().unbind(1)
    dof = do.float()
    qt, kt, vt, dot = _tiles(q), _tiles(k), _tiles(v), _tiles(dof)
    # (B) per query row: statistics over the key tiles, then delta, then dq.
    acc = [q @ kj.transpose(-1, -2) for kj in kt]
    m, s = _stats(acc, ls)
    inv = 1.0 / s
    wf = [_exp(a, ls, m) * inv for a in acc]
    dp = [dof @ vj.transpose(-1, -2) for vj in vt]
    delta = sum((dpj * wfj.to(lp).float()).sum(-1, keepdim=True) for dpj, wfj in zip(dp, wf))
    dq = sum(_split_product((wfj * (dpj - delta)) * scale, kj) for wfj, dpj, kj in zip(wf, dp, kt))
    # (A) per key tile, over the query tiles, from the statistics.
    stats = [[x[..., i * _TILE:(i + 1) * _TILE, :].transpose(-1, -2) for x in (m, inv, delta)]
             for i in range(len(qt))]
    dk, dv = [], []
    for kj, vj in zip(kt, vt):
        dkj, dvj = torch.zeros_like(kj), torch.zeros_like(vj)
        for qi, doi, (mi, invi, di) in zip(qt, dot, stats):
            wft = _exp(kj @ qi.transpose(-1, -2), ls, mi) * invi
            dvj = dvj + wft.to(lp).float() @ doi
            dst = (wft * (vj @ doi.transpose(-1, -2) - di)) * scale
            dkj = dkj + _split_product(dst, qi)
        dk.append(dkj)
        dv.append(dvj)
    return torch.stack([dq, torch.cat(dk, -2), torch.cat(dv, -2)], dim=1).to(lp)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("S", [128, 512, 896])
def test_kernel_tiling_model_matches_plain_and_jax(monkeypatch, S, dtype):
    """The model of the kernels' tiling agrees with the plain forward and
    backward and with the JAX kernels in interpret mode at the tolerances of
    the tests above: S = 128 takes the one-pass forward, 512 and 896 (the
    gate's largest S at D = 64) the two-pass route."""
    j = _jax(dtype)
    monkeypatch.setattr(j.pa, "INTERPRET", True)
    tdtype = _DTYPES[dtype][1]
    N, H, D = 1, 2, 64
    qkv_t = _qkv_t(N, H, S, D, seed=5)
    do = np.random.default_rng(6).standard_normal((N, H, S, D)).astype(np.float32)
    scale = 1.0 / math.sqrt(D)
    t_qkv, t_do = torch.from_numpy(qkv_t).to(tdtype), torch.from_numpy(do).to(tdtype)
    out, grad = _model_forward(t_qkv, scale), _model_backward(t_qkv, t_do, scale)
    assert out.dtype == grad.dtype == tdtype
    _assert_close(out, tatt.attn_reference_t(t_qkv, scale).float().numpy(), dtype)
    _assert_close(grad, tatt.attention_t_bwd_reference(t_qkv, t_do, scale).float().numpy(), dtype)
    ref, vjp = j.jax.vjp(lambda a: j.pa.fused_attention_t(a, scale),
                         j.jnp.asarray(qkv_t, j.dtype))
    _assert_close(out, ref, dtype)
    _assert_close(grad, vjp(j.jnp.asarray(do, j.dtype))[0], dtype)


def test_two_pass_bf16_weights_equal_direct_softmax_but_at_ties():
    """The kernels' bf16 weights on the two-pass route (2^(acc * scale log2 e
    - max), a rescaled running sum over 64-key tiles, times 1 / sum) equal
    those of the direct exp(l - max) / sum(e) except where the two f32
    values straddle a bf16 rounding boundary; then they are one bf16 step
    apart. At this seed 40 of 1,605,632 weights differ (S = 896, 2 heads)."""
    H, S, D = 2, 896, 64
    qkv = torch.from_numpy(_qkv_t(1, H, S, D, seed=7)).to(torch.bfloat16).float()
    acc = qkv[:, 0] @ qkv[:, 1].transpose(-1, -2)
    l = acc * 0.125
    e = torch.exp(l - l.amax(-1, keepdim=True))
    direct = e / e.sum(-1, keepdim=True)
    ls = _log2_scale(0.125)
    m, s = _running_stats(_tiles(acc, -1), ls)
    tiled = _exp(acc, ls, m) * (1.0 / s)
    wd, wt = direct.to(torch.bfloat16), tiled.to(torch.bfloat16)
    differ = wd != wt
    assert differ.sum().item() == 40
    # Each differing pair is one bf16 step apart (neighbouring bit patterns of
    # positive numbers), and the f32 weights lie within a few f32 ulps of the
    # bf16 midpoint between them.
    bits = (wd[differ].view(torch.int16).int() - wt[differ].view(torch.int16).int()).abs()
    assert (bits == 1).all()
    a, b = wd[differ].float(), wt[differ].float()
    mid = (a + b) / 2
    ulp = torch.finfo(torch.float32).eps * mid
    assert ((direct[differ] - mid).abs() <= 4 * ulp).all()
    assert ((tiled[differ] - mid).abs() <= 4 * ulp).all()


def test_split_of_ds_is_exact_and_its_products_match_f32():
    """ds = hi + mid + lo bit for bit, each part a bf16 value, on f32 values
    over a wide exponent range; and ds @ k from the three bf16 products
    equals the f32 product to f32 accumulation rounding (the float64 product
    of the same operands is the judge)."""
    rng = np.random.default_rng(8)
    x = (rng.standard_normal(1 << 16) * np.exp2(rng.integers(-60, 60, 1 << 16))).astype(np.float32)
    ds = torch.from_numpy(x)
    hi, mid, lo = _split(ds)
    for part in (hi, mid, lo):
        assert torch.equal(part.to(torch.bfloat16).float(), part)
    assert torch.equal(hi + mid + lo, ds)
    assert torch.equal((hi + mid) + lo, ds)
    dsm = torch.from_numpy(rng.standard_normal((256, 256)).astype(np.float32) * 1e-2)
    k = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32)).to(torch.bfloat16).float()
    exact = dsm.double() @ k.double()
    bound = 256 * torch.finfo(torch.float32).eps * (dsm.abs().double() @ k.abs().double())
    assert ((_split_product(dsm, k).double() - exact).abs() <= bound).all()
    assert ((dsm @ k).double() - exact).abs().max() <= bound.max()
    one_round = dsm.to(torch.bfloat16).float() @ k
    assert ((one_round.double() - exact).abs() > bound).any()
