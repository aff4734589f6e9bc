"""FID of a CIFAR-10 checkpoint with the reference's 50k protocol
(counterpart of ``examples/compute_fid.py``).

Loads the EMA parameters of the checkpoint under ``<output_dir>/checkpoints``
(the latest, or ``--step``), generates ``--num_gen`` images in batches by
integrating the learned field from N(0, I) (dopri5 at rtol = atol =
``--tol``, or a fixed-step method at ``--integration_steps``), quantises
them with ``quantize_to_uint8`` (x * 127.5 + 128, clipped, truncated) and
computes the FID against the CIFAR-10 training split.

The features are InceptionV3's (``eval/inception.py``) when
``CFM_TPU_INCEPTION_WEIGHTS`` names an npz of ported weights, else the
tracking features, whose number is not comparable to published FIDs.

Usage:
  python -m cfm_tpu_torch.compute_fid --model otcfm --integration_method dopri5
  python -m cfm_tpu_torch.compute_fid --model otcfm --integration_method euler \\
      --integration_steps 100 --num_gen 10000
  python -m cfm_tpu_torch.compute_fid --synthetic --num_gen 4096 --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

MODEL_TO_MATCHER = {"otcfm": "otcfm", "icfm": "icfm", "fm": "fm", "si": "vpcfm"}


def main(argv=None) -> float:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="otcfm", choices=["otcfm", "icfm", "fm", "si"])
    p.add_argument("--output_dir", default="results")
    p.add_argument("--data_dir", default="data")
    p.add_argument("--integration_method", default="dopri5",
                   choices=["dopri5", "euler", "rk4"])
    p.add_argument("--integration_steps", type=int, default=100)
    p.add_argument("--num_gen", type=int, default=50000)
    p.add_argument("--batch_size_fid", type=int, default=1024)
    p.add_argument("--tol", type=float, default=1e-5)
    p.add_argument("--step", type=int, default=None, help="checkpoint step (default latest)")
    p.add_argument("--mode", default="legacy_tensorflow",
                   choices=["legacy_tensorflow", "pytorch_fid"],
                   help="FID preprocessing; legacy_tensorflow is the reference's protocol")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic reference images: a plumbing rehearsal, NOT an FID")
    p.add_argument("--num_ref", type=int, default=0,
                   help="cap the reference images (0: the whole training split, the protocol)")
    p.add_argument("--device", default=None, help="default: the current CUDA device")
    p.add_argument("--override", action="append", default=[],
                   help="extra config key=value overrides (repeatable); they must match "
                        "the overrides the checkpoint was trained with")
    args = p.parse_args(argv)

    from cfm_tpu_torch.config import load_config
    from cfm_tpu_torch.data.images import load_cifar10
    from cfm_tpu_torch.eval.fid import (batched_features, fid_from_features,
                                        inception_feature_fn, make_tracking_feature_fn)
    from cfm_tpu_torch.generate import generate
    from cfm_tpu_torch.trainer import Trainer

    cfg = load_config(f"cifar10_{MODEL_TO_MATCHER[args.model]}", [
        f"trainer.ckpt_dir={args.output_dir}/checkpoints",
        f"data.data_dir={args.data_dir}",
    ] + list(args.override))
    cfg.name = f"cifar10_{args.model}"
    trainer = Trainer(cfg, device=args.device, log_dir=f"{args.output_dir}/logs")
    if trainer.ckpt.latest_step() is None:
        raise SystemExit("no checkpoint found — train first")
    if args.step is not None:
        trainer.ckpt.restore(trainer.state, step=args.step)
    print(f"evaluating checkpoint at step {trainer.state.step}")

    model = trainer._ema()  # the EMA parameters, as the reference evaluates
    noise = torch.Generator(device=trainer.device).manual_seed(0)
    gen_images, total_nfe, done = [], 0, 0
    while done < args.num_gen:
        n = min(args.batch_size_fid, args.num_gen - done)
        out = generate(model, n, x_shape=tuple(cfg.model.image_dim),
                       method=args.integration_method, n_steps=args.integration_steps,
                       rtol=args.tol, atol=args.tol, generator=noise, device=trainer.device)
        gen_images.append(out.images.cpu().numpy())
        total_nfe += out.nfe
        done += n
        print(f"generated {done}/{args.num_gen} (nfe/batch {out.nfe})", flush=True)
    gen_images = np.concatenate(gen_images)

    try:
        ref_images, _ = load_cifar10(args.data_dir, train=True, synthetic=args.synthetic)
    except FileNotFoundError:
        raise SystemExit("CIFAR-10 train split not found on disk; FID reference statistics "
                         "require the real dataset (or pass --synthetic for a plumbing "
                         "rehearsal)")
    if args.num_ref:
        ref_images = ref_images[:args.num_ref]

    try:
        feature_fn = inception_feature_fn(mode=args.mode, device=trainer.device)
        feat_kind = f"inception[{args.mode}]"
    except FileNotFoundError:
        feature_fn = make_tracking_feature_fn(tuple(cfg.model.image_dim), device=trainer.device)
        feat_kind = "tracking (NOT comparable to published FID)"
    print(f"feature network: {feat_kind}")

    g = batched_features(feature_fn, gen_images, 256, device=trainer.device)
    r = batched_features(feature_fn, ref_images, 256, device=trainer.device)
    fid = fid_from_features(g, r)
    batches = max(1, done // args.batch_size_fid)
    print(f"FID[{feat_kind}] = {fid:.4f}  (num_gen={args.num_gen}, "
          f"method={args.integration_method}, mean NFE/batch={total_nfe // batches})")
    return fid


if __name__ == "__main__":
    main()
