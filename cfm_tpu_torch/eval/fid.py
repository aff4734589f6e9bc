"""FID: the Frechet statistics and the feature networks (counterpart of
``cfm_tpu/eval/fid.py``).

1. Statistics: ``compute_statistics`` (mean and covariance in float64) and
   ``frechet_distance`` (the matrix square root by scipy on the host, with
   the same eps fallback for near-singular covariances).
2. InceptionV3 pool3 features (``eval/inception.py``), from an npz of
   ported weights named by ``CFM_TPU_INCEPTION_WEIGHTS`` or a path.
3. Tracking features, for when there are no Inception weights: three
   stride-2 3x3 convolutions with ReLU under fixed random kernels, a global
   mean and a fixed projection. Their "FID" is not comparable to published
   numbers; it falls as two distributions approach each other, so it tracks
   training. The kernels are the port's own draws from a
   ``torch.Generator`` (JAX draws its own with ``jax.random``), at the same
   shapes and scales; ``tracking_features`` takes them as tensors.

A feature function maps a uint8 NHWC batch on the device to (N, D) float32
features. The convolutions are cuDNN's on the card (TF32 unless
``device.strict_f32``), as JAX's are ``lax.conv``.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from cfm_tpu_torch.device import DeviceLike, resolve_device

FeatureFn = Callable[[torch.Tensor], torch.Tensor]


def compute_statistics(features: Union[np.ndarray, torch.Tensor]) -> Tuple[np.ndarray, np.ndarray]:
    """Feature mean and covariance, in float64."""
    if isinstance(features, torch.Tensor):
        features = features.detach().cpu().numpy()
    feats = np.asarray(features, np.float64)
    return feats.mean(axis=0), np.cov(feats, rowvar=False)


def _sqrtm(a: np.ndarray) -> np.ndarray:
    import scipy.linalg

    out = scipy.linalg.sqrtm(a)
    return out[0] if isinstance(out, tuple) else out  # older scipy: (sqrtm, errest)


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray,
                     eps: float = 1e-6) -> float:
    """||mu1 - mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)); where the square root
    is not finite, eps is added to both diagonals and it is taken again."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = _sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fid_from_features(gen_feats, ref_feats) -> float:
    mu1, s1 = compute_statistics(gen_feats)
    mu2, s2 = compute_statistics(ref_feats)
    return frechet_distance(mu1, s1, mu2, s2)


def batched_features(feature_fn: FeatureFn, images: Union[np.ndarray, torch.Tensor],
                     batch_size: int = 256, device: DeviceLike = None) -> np.ndarray:
    """``feature_fn`` over uint8 NHWC ``images`` (host or device) in batches
    on ``device``; the features come back as one float32 host array."""
    device = resolve_device(device)
    feats = []
    with torch.inference_mode():
        for i in range(0, images.shape[0], batch_size):
            batch = torch.as_tensor(images[i:i + batch_size]).to(device)
            feats.append(feature_fn(batch).float().cpu().numpy())
    return np.concatenate(feats, axis=0)


def compute_fid(feature_fn: FeatureFn, gen_images, ref_images, batch_size: int = 256,
                device: DeviceLike = None) -> float:
    """FID between two uint8 image sets under ``feature_fn``."""
    g = batched_features(feature_fn, gen_images, batch_size, device)
    r = batched_features(feature_fn, ref_images, batch_size, device)
    return fid_from_features(g, r)


TRACKING_CHANNELS = (32, 64, 128)


def tracking_kernels(image_shape: Sequence[int], feature_dim: int = 256, seed: int = 0,
                     device: DeviceLike = None) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The tracking network's frozen weights: three HWIO kernels drawn from
    N(0, 2 / fan_in) and a (128, feature_dim) projection from N(0, 1 / 128),
    drawn on the CPU from ``seed`` (the same numbers on every device)."""
    g = torch.Generator().manual_seed(seed)
    chans = [image_shape[-1], *TRACKING_CHANNELS]
    kernels = []
    for cin, cout in zip(chans[:-1], chans[1:]):
        k = torch.randn((3, 3, cin, cout), generator=g) * np.sqrt(2.0 / (9 * cin))
        kernels.append(k)
    proj = torch.randn((chans[-1], feature_dim), generator=g) / np.sqrt(chans[-1])
    device = resolve_device(device)
    return [k.to(device) for k in kernels], proj.to(device)


def _same_pad_stride2(x: torch.Tensor) -> torch.Tensor:
    """XLA's SAME padding of an NCHW input for a 3x3 window at stride 2:
    ceil(in / 2) outputs, the odd pad element at the end."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max(((size + 1) // 2 - 1) * 2 + 3 - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def tracking_features(x_uint8: torch.Tensor, kernels: Sequence[torch.Tensor],
                      proj: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) uint8 -> (N, feature_dim): [-1, 1], three stride-2 SAME
    convolutions with ReLU (``kernels`` HWIO), a global mean, ``proj``."""
    x = (x_uint8.float() / 127.5 - 1.0).permute(0, 3, 1, 2)
    for k in kernels:
        x = F.relu(F.conv2d(_same_pad_stride2(x), k.permute(3, 2, 0, 1), stride=2))
    return x.mean(dim=(2, 3)) @ proj


def make_tracking_feature_fn(image_shape: Sequence[int], feature_dim: int = 256, seed: int = 0,
                             device: DeviceLike = None) -> FeatureFn:
    """The tracking feature function of ``tracking_kernels(image_shape,
    feature_dim, seed)`` on ``device``."""
    kernels, proj = tracking_kernels(image_shape, feature_dim, seed, device)
    return lambda x: tracking_features(x, kernels, proj)


def inception_feature_fn(weights_path: Optional[str] = None, mode: str = "legacy_tensorflow",
                         device: DeviceLike = None) -> FeatureFn:
    """InceptionV3 pool3 features (2048-d) of uint8 NHWC images, with the
    weights of ``weights_path`` or ``CFM_TPU_INCEPTION_WEIGHTS``. ``mode``:
    "legacy_tensorflow" (clean-fid's legacy mode, the reference's headline
    protocol) or "pytorch_fid". Raises ``FileNotFoundError`` with guidance
    when there are no weights."""
    from cfm_tpu_torch.eval.inception import InceptionV3Features, load_inception_params

    weights_path = weights_path or os.environ.get("CFM_TPU_INCEPTION_WEIGHTS")
    if not weights_path or not os.path.exists(weights_path):
        raise FileNotFoundError(
            "InceptionV3 FID weights not found. Port them offline with "
            "cfm_tpu_torch.eval.inception.port_torch_inception_weights(state_dict, npz_path) "
            "and set CFM_TPU_INCEPTION_WEIGHTS=<npz_path>. For weight-free "
            "progress tracking use make_tracking_feature_fn instead."
        )
    model = InceptionV3Features(mode=mode)
    model.load_params(load_inception_params(weights_path))
    model = model.to(resolve_device(device)).eval()
    return model
