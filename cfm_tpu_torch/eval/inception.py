"""The InceptionV3 feature trunk of the FID evaluators, pool3 (2048-d), as an
``nn.Module`` on uint8 NHWC images (counterpart of ``cfm_tpu/eval/inception.py``).

The torchvision InceptionV3 trunk with pytorch-fid's changes: average pools
that leave the padding out of the count in the A, C and E blocks, and a max
pool in the last E block. Evaluation only: BatchNorm is its folded affine
form, ``(x - mean) * scale / sqrt(var + 1e-3) + bias``. The module's names
are pytorch-fid's (``Mixed_5b.branch1x1.conv.weight``,
``...bn.running_var``), so ``port_torch_inception_weights(model.state_dict(),
npz)`` writes the npz that both packages load (``load_inception_params``).

Preprocessing (``mode``):
- "legacy_tensorflow": TF1's ``resize_bilinear(align_corners=False)`` to
  299x299 on the raw 0..255 values (source coordinate dest * in / out, no
  half-pixel shift), then (x - 128) / 128: clean-fid's legacy mode.
- "pytorch_fid": / 255, the half-pixel bilinear resize to 299x299
  (antialiased when shrinking, as JAX's ``jax.image.resize``), then 2x - 1.
One channel is repeated to three. The convolutions run NCHW inside.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3
SIZE = 299


def tf1_resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """TF1 ``resize_bilinear(align_corners=False)`` of NHWC ``x``, in float32."""
    n, in_h, in_w, c = x.shape
    x = x.float()

    def axis_coords(in_size: int, out_size: int):
        src = torch.arange(out_size, dtype=torch.float32, device=x.device) * (in_size / out_size)
        lo = torch.floor(src).long()
        hi = torch.clamp(lo + 1, max=in_size - 1)
        return lo, hi, src - lo.float()

    lo_h, hi_h, fh = axis_coords(in_h, out_h)
    lo_w, hi_w, fw = axis_coords(in_w, out_w)
    top, bot = x[:, lo_h], x[:, hi_h]
    rows = top + (bot - top) * fh[None, :, None, None]
    left, right = rows[:, :, lo_w], rows[:, :, hi_w]
    return left + (right - left) * fw[None, None, :, None]


def pytorch_fid_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Half-pixel bilinear resize of NHWC ``x`` (``align_corners=False``),
    antialiased only when an axis shrinks, as ``jax.image.resize`` is."""
    shrink = out_h < x.shape[1] or out_w < x.shape[2]
    y = F.interpolate(x.float().permute(0, 3, 1, 2), size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=shrink)
    return y.permute(0, 2, 3, 1)


def _avg_pool_nocountpad(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


class _FoldedBN(nn.Module):
    """Inference BatchNorm, pytorch-fid's buffer names, JAX's arithmetic."""

    def __init__(self, channels: int):
        super().__init__()
        for name, fill in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                           ("running_var", 1.0)):
            self.register_buffer(name, torch.full((channels,), fill))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def v(t):
            return t.view(1, -1, 1, 1)

        return ((x - v(self.running_mean)) * v(self.weight) * torch.rsqrt(v(self.running_var) + BN_EPS)
                + v(self.bias))


class BasicConv2d(nn.Module):
    """Convolution without bias, folded BatchNorm, ReLU."""

    def __init__(self, cin: int, cout: int, kernel: Union[int, Tuple[int, int]], stride: int = 1,
                 padding: Union[int, Tuple[int, int]] = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = _FoldedBN(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_nocountpad(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_nocountpad(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7, _max_pool(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool  # "avg" (Mixed_7b) | "max" (Mixed_7c, pytorch-fid's FIDInceptionE_2)
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = (_avg_pool_nocountpad(x) if self.pool == "avg"
              else F.max_pool2d(x, 3, stride=1, padding=1))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


_MIXED = ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d",
          "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c")


class InceptionV3Features(nn.Module):
    """uint8 NHWC images of any size -> (N, 2048) pool3 features, float32."""

    def __init__(self, mode: str = "pytorch_fid"):
        super().__init__()
        if mode not in ("legacy_tensorflow", "pytorch_fid"):
            raise ValueError(f"Unknown FID mode: {mode}")
        self.mode = mode
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, pool="avg")
        self.Mixed_7c = InceptionE(2048, pool="max")
        self.requires_grad_(False)

    def preprocess(self, x_uint8: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC -> the trunk's float NHWC input at 299x299, 3 channels."""
        if self.mode == "legacy_tensorflow":
            x = (tf1_resize_bilinear(x_uint8, SIZE, SIZE) - 128.0) / 128.0
        else:
            x = 2.0 * pytorch_fid_resize(x_uint8.float() / 255.0, SIZE, SIZE) - 1.0
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        return x

    def forward(self, x_uint8: torch.Tensor) -> torch.Tensor:
        x = self.preprocess(x_uint8).permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool(x)))
        x = _max_pool(x)
        for name in _MIXED:
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))

    def load_params(self, params: Mapping[str, Any]) -> "InceptionV3Features":
        """Copy the npz layout's weights (``Mixed_5b/branch1x1/conv/kernel``
        HWIO, ``.../bn_scale``, ``bn_bias``, ``bn_mean``, ``bn_var``) into
        the module. Every tensor must be set, once, at its shape."""
        leaf = {"bn_scale": "bn.weight", "bn_bias": "bn.bias", "bn_mean": "bn.running_mean",
                "bn_var": "bn.running_var"}
        own = dict(self.named_parameters())
        own.update(self.named_buffers())
        todo = set(own)
        for key, value in params.items():
            *path, last = key.replace(".", "/").split("/")
            value = torch.tensor(np.asarray(value))
            if last == "kernel" and path[-1:] == ["conv"]:
                name, value = ".".join(path) + ".weight", value.permute(3, 2, 0, 1)
            elif last in leaf:
                name = ".".join(path + [leaf[last]])
            else:
                raise KeyError(f"unexpected Inception weight {key!r}")
            if name not in todo or own[name].shape != value.shape:
                raise ValueError(f"Inception weight {key!r} of shape {tuple(value.shape)} does "
                                 f"not fit {name!r}")
            with torch.no_grad():
                own[name].copy_(value)
            todo.discard(name)
        if todo:
            raise ValueError(f"{len(todo)} Inception weights missing, e.g. {sorted(todo)[:3]}")
        return self


def port_torch_inception_weights(state_dict: Mapping[str, Any], npz_path: str) -> None:
    """Write a pytorch-fid InceptionV3 state dict (``Mixed_5b.branch1x1.conv.weight``
    OIHW, ``...bn.{weight,bias,running_mean,running_var}``) as the npz that
    both packages load; the classifier (``fc``) and ``AuxLogits`` are left out."""
    out = {}
    for name, tensor in state_dict.items():
        if name.startswith(("AuxLogits", "fc.")):
            continue
        t = tensor.detach().cpu().numpy() if isinstance(tensor, torch.Tensor) else np.asarray(tensor)
        if name.endswith(".conv.weight"):
            out[name[:-len(".conv.weight")] + "/conv/kernel"] = t.transpose(2, 3, 1, 0)
        elif name.endswith(".bn.weight"):
            out[name[:-len(".bn.weight")] + "/bn_scale"] = t
        elif name.endswith(".bn.bias"):
            out[name[:-len(".bn.bias")] + "/bn_bias"] = t
        elif name.endswith(".bn.running_mean"):
            out[name[:-len(".bn.running_mean")] + "/bn_mean"] = t
        elif name.endswith(".bn.running_var"):
            out[name[:-len(".bn.running_var")] + "/bn_var"] = t
    np.savez(npz_path, **out)


def load_inception_params(npz_path: str) -> Dict[str, np.ndarray]:
    """The npz's arrays by "/"-joined name (dots read as "/", as JAX reads them)."""
    with np.load(npz_path) as raw:
        return {k.replace(".", "/"): raw[k] for k in raw.files}
