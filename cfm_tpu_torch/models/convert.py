"""Flax parameters -> a ``state_dict`` of the port's models.

:func:`mlp_params_from_flax` maps the 2-D ``MLP``'s ``Dense_k/{kernel,bias}``
to ``Dense_k.{weight,bias}``, the (in, out) kernel transposed;
:func:`mlp_pair_params_from_flax` maps the [SF]2M trainer's
``{"flow": ..., "score": ...}`` pair to the flow and score MLPs.
:func:`unet_params_from_flax` maps the UNet family's trees.
:func:`mlpodef_params_from_flax` maps the GRN family's (``MLPODEF``,
``HyperMLPODEF``, ``BayesMLPODEF``, ``DibsMLPODEF``, ``DeepSet``), stacked
ensembles included. :func:`variables_from_flax` maps the variables of the
rest of ``models/mlp.py`` (``VelocityNet`` with its ``batch_stats``,
``TimeInvariantVelocityNet``, ``SimpleDenseNet``, ``_ActionNet``,
``GradModel``, ``ICNN``) and of every module of ``models/diffeq.py``.

The torch modules carry the flax scope names, so each leaf maps by its path:

- conv ``kernel`` (kh, kw, in, out) HWIO -> ``weight`` (out, in, kh, kw) OIHW;
- ``Dense`` ``kernel`` (in, out) -> ``weight`` (out, in);
- GroupNorm ``scale``/``bias`` -> ``weight``/``bias``; ``Embed``
  ``embedding`` -> ``weight``;
- attention ``qkv_kernel`` (C, 3, H, D), ``qkv_bias`` (3, H, D) and
  ``proj_kernel`` (H, D, C) are flattened in [k][h][d] order, exactly as the
  JAX AttentionBlock flattens them for its block kernel;
- ``AttentionPool2d``'s ``positional_embedding`` (H*W + 1, C) as it is.

The same mapping serves ``SuperResModel`` (its UNet under ``base``) and
``EncoderUNetModel`` (its pool ``Dense`` layers, spatial heads and
``AttentionPool2d_0``).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_ATTN_LEAVES = {
    "qkv_kernel": ("qkv_weight", lambda a: a.reshape(a.shape[0], -1)),
    "qkv_bias": ("qkv_bias", lambda a: a.reshape(-1)),
    "proj_kernel": ("proj_weight", lambda a: a.reshape(-1, a.shape[-1])),
    "proj_bias": ("proj_bias", lambda a: a),
}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, dtype=np.float32)


def _convert_leaf(name: str, a: np.ndarray) -> Tuple[str, np.ndarray]:
    if name in _ATTN_LEAVES:
        new, f = _ATTN_LEAVES[name]
        return new, f(a)
    if name == "kernel":
        if a.ndim == 4:
            return "weight", a.transpose(3, 2, 0, 1)
        if a.ndim == 2:
            return "weight", a.T
        raise ValueError(f"unexpected kernel of rank {a.ndim}")
    if name == "positional_embedding":
        return name, a
    if name in ("scale", "embedding"):
        return "weight", a
    if name == "bias":
        return "bias", a
    raise ValueError(f"unknown flax parameter {name!r}")


def mlp_params_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``params``: the flax ``MLP``'s ``params`` collection. Returns float32
    CPU tensors keyed like ``MLP.state_dict()``."""
    out = {}
    for path, a in _leaves(params):
        if len(path) != 2 or not path[0].startswith("Dense_") or path[1] not in ("kernel", "bias"):
            raise ValueError(f"unexpected MLP parameter {'/'.join(path)}")
        name, value = ("weight", a.T) if path[1] == "kernel" else ("bias", a)
        out[f"{path[0]}.{name}"] = torch.tensor(value)  # a copy: flax arrays are read-only
    return out


def mlp_pair_params_from_flax(params: Mapping[str, Any]
                              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``params``: JAX's ``{"flow": variables, "score": variables}`` (each a
    flax ``MLP``'s variables with a ``params`` collection). Returns the flow
    and the score MLP's state dicts."""
    return tuple(mlp_params_from_flax(params[k]["params"]) for k in ("flow", "score"))


def unet_params_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``params``: the flax ``params`` collection as nested dicts of arrays.
    Returns float32 CPU tensors keyed like ``UNetModel.state_dict()``; load
    them with ``model.load_state_dict(..., strict=True)``."""
    out = {}
    for path, a in _leaves(params):
        name, value = _convert_leaf(path[-1], a)
        out[".".join(path[:-1] + (name,))] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def mlpodef_params_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``params``: the ``params`` collection of a flax ``MLPODEF``,
    ``HyperMLPODEF``, ``BayesMLPODEF``, ``DibsMLPODEF`` or ``DeepSet``, or of a
    ``make_ensemble`` init, whose leaves carry a leading member axis. Returns
    float32 CPU tensors keyed like the port module's ``named_parameters()``
    (the ensemble's axis kept in front): a ``Dense`` ``kernel`` (in, out)
    becomes ``weight`` (out, in); every other leaf (biases, the
    locally-connected (d, m_in, m_out) weights, edge logits, the DiBS
    factors, ``fc1_kernel``) keeps its layout."""
    out = {}
    for path, a in _leaves(params):
        name, value = path[-1], a
        if name == "kernel":
            name, value = "weight", np.swapaxes(a, -1, -2)
        out[".".join(path[:-1] + (name,))] = torch.tensor(np.ascontiguousarray(value))
    return out


def variables_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``variables``: a flax module's variables, ``{"params": ...}`` with
    ``"batch_stats"`` where the module has batch norms. Returns float32 CPU
    tensors keyed like the port module's ``state_dict()``: a ``Dense``
    ``kernel`` (in, out) becomes ``weight`` (out, in), a conv or transposed
    conv ``kernel`` (kh, kw, in, out) ``weight`` (out, in, kh, kw), a norm's
    ``scale`` its ``weight``; biases, the ICNN's raw ``wz_*`` (in, out) and
    the batch statistics ``mean`` and ``var`` keep their layout."""
    out = {}
    for collection in ("params", "batch_stats"):
        for path, a in _leaves(variables.get(collection, {})):
            name, value = path[-1], a
            if name == "kernel":
                name, value = _convert_leaf(name, a)
            elif name == "scale":
                name = "weight"
            elif not (name in ("bias", "mean", "var") or name.startswith("wz_")):
                raise ValueError(f"unknown flax variable {'/'.join(path)}")
            out[".".join(path[:-1] + (name,))] = torch.tensor(np.ascontiguousarray(value))
    return out
