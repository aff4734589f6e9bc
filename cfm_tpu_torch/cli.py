"""Command line (counterpart of ``cfm_tpu/cli.py``):

  python -m cfm_tpu_torch.cli train 2d_otcfm trainer.ckpt_interval=0
  python -m cfm_tpu_torch.cli train 2d_icfm trainer.total_steps=800 --device cpu
  python -m cfm_tpu_torch.cli presets

``train <preset> [group.field=value ...]`` trains on ``--device`` (default:
the current CUDA device; ``--device cpu`` runs the plain PyTorch path) and
ends with a final evaluation (W1, W2 and NFE) on the 2-D presets, whose
image counterpart, tracking FID, is not ported yet. Checkpointing is not
ported: a preset that saves one during the run needs
``trainer.ckpt_interval=0``, and ``eval`` (which restores one) refuses.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from cfm_tpu_torch.config import available_presets, load_config
from cfm_tpu_torch.trainer import Trainer


def _pop_device(argv: List[str]) -> Optional[str]:
    """Remove ``--device D`` or ``--device=D`` from ``argv``; return D."""
    for i, a in enumerate(argv):
        if a == "--device":
            if i + 1 >= len(argv):
                raise SystemExit("--device needs a value, such as cuda or cpu")
            device = argv[i + 1]
            del argv[i:i + 2]
            return device
        if a.startswith("--device="):
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
    if cmd == "eval":
        raise NotImplementedError("eval restores a checkpoint, and checkpointing is not ported "
                                  "yet (ROADMAP.md queue 1 item 9); `train` ends with an "
                                  "evaluation")
    if cmd != "train":
        print(f"unknown command {cmd!r}; use train | eval | presets")
        return 2
    device = _pop_device(argv)
    if not argv:
        print("missing preset name; see `presets`")
        return 2
    preset = argv.pop(0)
    cfg = load_config(preset, argv)
    print(f"config: {cfg.name} {' '.join(argv)}".rstrip())
    trainer = Trainer(cfg, device=device)
    trainer.fit()
    if not trainer.is_image:
        print("final eval:", trainer.evaluate())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
