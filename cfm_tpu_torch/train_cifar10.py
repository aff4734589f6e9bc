"""CIFAR-10 flow-matching training on one card (counterpart of
``examples/train_cifar10.py``).

Recipe: UNet 128ch (1, 2, 2, 2), 4 heads x 64, attention at 16x16, dropout
0.1, bf16; Adam 2e-4 with a 5k-step linear warmup, grad clip 1.0, EMA
0.9999; batch 128.

Usage:
  python -m cfm_tpu_torch.train_cifar10 --model otcfm --synthetic --total_steps 50

Checkpoints go to ``<output_dir>/checkpoints/cifar10_<model>`` every
``--save_step`` steps and at the end (a rerun resumes from the latest), the
metric logs to ``<output_dir>/logs``; the tracking FID is evaluated every
``trainer.eval_interval`` steps (5000).
"""

from __future__ import annotations

import argparse

from cfm_tpu_torch.config import load_config
from cfm_tpu_torch.trainer import Trainer

MODEL_TO_MATCHER = {"otcfm": "otcfm", "icfm": "icfm", "fm": "fm", "si": "vpcfm"}


def main(argv=None) -> Trainer:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="otcfm", choices=sorted(MODEL_TO_MATCHER))
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--total_steps", type=int, default=400001)
    p.add_argument("--warmup", type=int, default=5000)
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--save_step", type=int, default=20000)
    p.add_argument("--data_dir", default="data")
    p.add_argument("--output_dir", default="results")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic images when CIFAR-10 is not on disk")
    p.add_argument("--no_bf16", action="store_true")
    p.add_argument("--device", default=None, help="default: the current CUDA device")
    p.add_argument("--override", action="append", default=[],
                   help="extra config key=value overrides (repeatable)")
    args = p.parse_args(argv)

    matcher = MODEL_TO_MATCHER[args.model]
    cfg = load_config(f"cifar10_{matcher}", [
        f"optim.lr={args.lr}",
        f"optim.warmup_steps={args.warmup}",
        f"optim.ema_decay={args.ema_decay}",
        f"optim.grad_clip={args.grad_clip}",
        f"data.batch_size={args.batch_size}",
        f"data.data_dir={args.data_dir}",
        f"data.synthetic_fallback={args.synthetic}",
        f"trainer.total_steps={args.total_steps}",
        f"trainer.ckpt_interval={args.save_step}",
        f"trainer.ckpt_dir={args.output_dir}/checkpoints",
        f"trainer.seed={args.seed}",
        f"model.bf16={not args.no_bf16}",
    ] + list(args.override))
    cfg.name = f"cifar10_{args.model}"
    trainer = Trainer(cfg, device=args.device, log_dir=f"{args.output_dir}/logs")
    trainer.fit()
    return trainer


if __name__ == "__main__":
    main()
