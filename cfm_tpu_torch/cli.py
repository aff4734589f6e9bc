"""Command line (counterpart of ``cfm_tpu/cli.py``):

  python -m cfm_tpu_torch.cli train 2d_otcfm trainer.total_steps=2000
  python -m cfm_tpu_torch.cli train cifar10_otcfm optim.lr=1e-4
  python -m cfm_tpu_torch.cli train configs/experiment/2d_icfm_quick.yaml --device cpu
  python -m cfm_tpu_torch.cli eval 2d_otcfm      # restore the latest checkpoint, evaluate
  python -m cfm_tpu_torch.cli presets

``train <preset or YAML file> [group.field=value ...]`` prints the config
tree, trains (checkpoints under ``<trainer.ckpt_dir>/<name>``, resuming from
the latest one there) and ends with a final evaluation: W1, W2 and NFE on
the 2-D presets, the samples' mean and std, the NFE and the tracking FID on
the image presets. ``eval`` restores the latest checkpoint and evaluates.
Both run on ``--device`` (default: the current CUDA device; ``--device cpu``
runs the plain PyTorch path) and log under ``--log_dir`` (default ``logs``).

On several cards, one process a card under ``torchrun``:

  torchrun --nproc_per_node=4 -m cfm_tpu_torch.cli train cifar10_otcfm

joins the process group torchrun describes (NCCL, card ``LOCAL_RANK``;
gloo with ``--device cpu``) and trains data-parallel
(``trainer.data_parallel``, the default): the global ``data.batch_size``
split over the ranks, rank 0 writing the logs and checkpoints. Without
torchrun's variables it runs as one process.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from cfm_tpu_torch.config import available_presets, load_config
from cfm_tpu_torch.parallel import initialize_distributed
from cfm_tpu_torch.trainer import Trainer


def _pop_flag(argv: List[str], flag: str) -> Optional[str]:
    """Remove ``--flag V`` or ``--flag=V`` from ``argv``; return V."""
    for i, a in enumerate(argv):
        if a == flag:
            if i + 1 >= len(argv):
                raise SystemExit(f"{flag} needs a value")
            value = argv[i + 1]
            del argv[i:i + 2]
            return value
        if a.startswith(flag + "="):
            del argv[i]
            return a.split("=", 1)[1]
    return None


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd = argv.pop(0)
    if cmd == "presets":
        for p in available_presets():
            print(p)
        return 0
    if cmd not in ("train", "eval"):
        print(f"unknown command {cmd!r}; use train | eval | presets")
        return 2
    device = _pop_flag(argv, "--device")
    log_dir = _pop_flag(argv, "--log_dir") or "logs"
    if not argv:
        print("missing preset name; see `presets`")
        return 2
    preset = argv.pop(0)
    cfg = load_config(preset, argv)
    initialize_distributed(device)
    print(cfg.tree_str())
    trainer = Trainer(cfg, device=device, log_dir=log_dir)
    if cmd == "train":
        trainer.fit()
        ev = trainer._on_main(trainer.evaluate)
        if ev is not None:
            print("final eval:", ev)
    else:
        if trainer.ckpt.latest_step() is None:
            print("no checkpoint to evaluate; run train first")
            return 1
        print("eval:", trainer.evaluate())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
