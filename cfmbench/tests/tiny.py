"""A tiny configuration and cells for the CPU tests, written into a
temporary folder that the harness searches before its own."""

from __future__ import annotations

import json
from pathlib import Path

ARCH = {"dim": [16, 16, 3], "num_channels": 32, "num_res_blocks": 1, "channel_mult": [1, 2],
        "num_head_channels": 16, "attention_resolutions": "8", "use_scale_shift_norm": True,
        "resblock_updown": True, "class_cond": True, "num_classes": 10, "dropout": 0.1,
        "learn_sigma": False}
OPTIMIZER = {"lr": 1e-4, "warmup_steps": 0, "grad_clip": 1.0, "b1": 0.9, "b2": 0.999,
             "eps": 1e-8, "ema_decay": 0.9999}
# Between the bf16 program's readings on the CPU (grad_gap 0.007-0.010) and
# the float8 control's (0.07-0.08); the others loose, so that one number
# decides here.
TRAIN_LIMITS = {"loss_gap": 0.01, "grad_gap": 0.03, "change_gap": 0.5, "ema_gap": 0.5}
GEN_LIMITS = {"image_rms_levels": 0.7}


def write(folder: Path, dtype: str = "bfloat16") -> Path:
    """tiny.json and the cells tiny-train, tiny-train-dp2, tiny-gen-euler,
    tiny-gen-dopri5 under ``folder``."""
    folder.mkdir(parents=True, exist_ok=True)
    config = {"name": "tiny", "source": "test", "model": ARCH, "dtype": dtype,
              "weights_seed": 5, "optimizer": OPTIMIZER}
    (folder / "tiny.json").write_text(json.dumps(config))
    train = {"checked_steps": 3, "warmup_steps": 1, "block": 4, "trace_steps": 2,
             "limits": TRAIN_LIMITS}
    cells = {
        "tiny-train": {"config": "tiny", "driver": "train", "chips": 1,
                       "traffic": dict(train, batch=8)},
        "tiny-train-dp2": {"config": "tiny", "driver": "train", "chips": 2,
                           "traffic": dict(train, batch=4, data_parallel=True)},
        "tiny-gen-euler": {"config": "tiny", "driver": "generate", "chips": 1,
                           "traffic": {"batch": 8, "method": "euler", "n_steps": 10,
                                       "check_rows": 4, "trace_evaluations": 3,
                                       "limits": GEN_LIMITS}},
        "tiny-gen-dopri5": {"config": "tiny", "driver": "generate", "chips": 1,
                            "traffic": {"batch": 4, "method": "dopri5", "rtol": 1e-5,
                                        "atol": 1e-5, "trace_evaluations": 3,
                                        "limits": GEN_LIMITS}},
    }
    for name, cell in cells.items():
        (folder / f"{name}.json").write_text(json.dumps(dict(cell, why="a CPU test")))
    return folder
