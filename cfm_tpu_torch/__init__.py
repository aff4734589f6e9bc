"""PyTorch port of ``cfm_tpu`` for one NVIDIA H100.

The JAX package ``cfm_tpu`` stays the reference; this package mirrors its
module names (``ops/attn_block.py`` <-> ``ops/pallas_attn_block.py``,
``models/unet.py`` <-> ``models/unet.py``, ...) and keeps its public layouts
(NHWC images, ``(N, S, C)`` tokens), so the tests hold each part against its
counterpart on shared numpy inputs.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request they raise. Every kernel the JAX package
wrote in Pallas becomes a hand-written CUDA kernel for ``sm_90a`` under
``csrc/``, built at first use; on CPU tensors each wrapper runs its plain
PyTorch version instead.

This package imports ``torch`` and never ``jax`` or anything of ``cfm_tpu``.
"""

from cfm_tpu_torch import (augment, config, data, eval, integrate, models, ops, parallel, schedules,
                           spline, train, variants)
from cfm_tpu_torch.coupling import OTPlanSampler, wasserstein
from cfm_tpu_torch.device import resolve_device, strict_f32
from cfm_tpu_torch.integrate import FlowSolver, odeint, odeint_adjoint, sdeint
from cfm_tpu_torch.paths import (ConditionalFlowMatcher, ExactOptimalTransportConditionalFlowMatcher,
                                 SchrodingerBridgeConditionalFlowMatcher,
                                 TargetConditionalFlowMatcher,
                                 VariancePreservingConditionalFlowMatcher)
from cfm_tpu_torch.utils import pad_t_like_x
from cfm_tpu_torch.version import __version__

__all__ = [
    "ConditionalFlowMatcher",
    "ExactOptimalTransportConditionalFlowMatcher",
    "SchrodingerBridgeConditionalFlowMatcher",
    "TargetConditionalFlowMatcher",
    "VariancePreservingConditionalFlowMatcher",
    "OTPlanSampler",
    "wasserstein",
    "pad_t_like_x",
    "FlowSolver",
    "odeint",
    "odeint_adjoint",
    "sdeint",
    "augment",
    "config",
    "data",
    "eval",
    "integrate",
    "models",
    "ops",
    "parallel",
    "schedules",
    "spline",
    "train",
    "variants",
    "resolve_device",
    "strict_f32",
    "__version__",
]
