"""The port's attention block (cfm_tpu_torch/ops/attn_block.py) against JAX.

The plain PyTorch version is held against the JAX block kernel run in Pallas
interpret mode on the CPU, at the tolerances the JAX package holds that
kernel to against its composition (f32 2e-4, bf16 3e-2), and against the
JAX composition in f32. The routing gates must agree with JAX's shape and
budget conditions. The CUDA kernel itself is checked against the plain
version by the ``cuda``-marked test, which skips without a card. The JAX
package is imported inside the tests that use it, so that the card-only
test also runs where only PyTorch is installed:
``python -m pytest tests/test_torch_attn_block.py -m cuda -q``.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

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
@pytest.mark.parametrize("N,S,C,H", [(4, 64, 256, 4), (8, 256, 256, 4)])
def test_kernel_matches_plain_on_cuda(N, S, C, H, dtype, tol):
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
    torch.cuda.synchronize()
    assert tab.fused_attention_block.launches == before + 1
    np.testing.assert_allclose(y.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=tol, rtol=tol)
