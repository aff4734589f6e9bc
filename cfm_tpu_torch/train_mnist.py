"""MNIST flow matching on one card, unconditional or class-conditional
(counterpart of ``examples/train_mnist.py``).

Presets: ``mnist_<matcher>`` (icfm, otcfm, fm, sbcfm, vpcfm), or with ``--conditional``
``mnist_otcfm_cond`` (OT-CFM whose coupling carries the labels into the
UNet's class embedding). After training it samples from the EMA parameters
with euler at ``eval.ode_steps`` steps (100 in the presets): 80 images, 8
per class, with ``--conditional``, else 64. The samples are saved as a uint8
(n, 28, 28, 1) array to ``<output_dir>/mnist_samples.npy`` (plotting waits
for ROADMAP.md queue 1 item 4).

Usage:
  python -m cfm_tpu_torch.train_mnist --matcher otcfm --steps 2000
  python -m cfm_tpu_torch.train_mnist --conditional --synthetic

``--sde`` (a score head sampled by SDE) waits for ROADMAP.md queue 1 items
2 and 6.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from cfm_tpu_torch.config import load_config
from cfm_tpu_torch.trainer import Trainer


def main(argv=None) -> Trainer:
    p = argparse.ArgumentParser()
    p.add_argument("--matcher", default="otcfm", choices=["icfm", "otcfm", "fm", "sbcfm", "vpcfm"])
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--conditional", action="store_true")
    p.add_argument("--sde", action="store_true", help="train a score head; sample via SDE")
    p.add_argument("--data_dir", default="data")
    p.add_argument("--output_dir", default="results")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic images when MNIST is not on disk")
    p.add_argument("--device", default=None, help="default: the current CUDA device")
    p.add_argument("--override", action="append", default=[],
                   help="extra config key=value overrides (repeatable)")
    args = p.parse_args(argv)

    if args.sde:
        raise NotImplementedError("--sde needs the score head and sdeint, which are not ported "
                                  "yet (ROADMAP.md queue 1 item 2)")
    preset = "mnist_otcfm_cond" if args.conditional else f"mnist_{args.matcher}"
    cfg = load_config(preset, [
        f"trainer.total_steps={args.steps}",
        f"data.batch_size={args.batch_size}",
        f"data.data_dir={args.data_dir}",
        f"data.synthetic_fallback={args.synthetic}",
    ] + list(args.override))
    trainer = Trainer(cfg, device=args.device)
    trainer.fit()

    gen = torch.Generator(device=trainer.device).manual_seed(1)
    if args.conditional:
        y = torch.arange(10, device=trainer.device).repeat_interleave(8)
        out = trainer.generate(80, method="euler", y=y, generator=gen)
    else:
        out = trainer.generate(64, method="euler", generator=gen)
    os.makedirs(args.output_dir, exist_ok=True)
    path = os.path.join(args.output_dir, "mnist_samples.npy")
    np.save(path, out.images.cpu().numpy())
    print(f"saved {out.images.shape[0]} samples (NFE {out.nfe}) to {path}")
    return trainer


if __name__ == "__main__":
    main()
