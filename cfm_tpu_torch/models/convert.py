"""Flax parameters -> a ``state_dict`` of the port's models.

:func:`mlp_params_from_flax` maps the 2-D ``MLP``'s ``Dense_k/{kernel,bias}``
to ``Dense_k.{weight,bias}``, the (in, out) kernel transposed.
:func:`unet_params_from_flax` maps the UNet family's trees.

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


def unet_params_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``params``: the flax ``params`` collection as nested dicts of arrays.
    Returns float32 CPU tensors keyed like ``UNetModel.state_dict()``; load
    them with ``model.load_state_dict(..., strict=True)``."""
    out = {}
    for path, a in _leaves(params):
        name, value = _convert_leaf(path[-1], a)
        out[".".join(path[:-1] + (name,))] = torch.from_numpy(np.ascontiguousarray(value))
    return out
