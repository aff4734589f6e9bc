"""The program under test as a cell's configuration builds it: the port's
UNet at the configuration's widths and dtype, holding the configuration's
weights (:mod:`cfmbench.weights`)."""

from __future__ import annotations

import torch

from cfmbench.weights import make_weights


def build_model(run):
    """``cfm_tpu_torch``'s ``UNetModelWrapper`` on the run's device."""
    from cfm_tpu_torch.models.unet import UNetModelWrapper

    cfg = run.cell.config
    arch = dict(cfg["model"], dim=tuple(cfg["model"]["dim"]))
    model = UNetModelWrapper(**arch, dtype=getattr(torch, cfg["dtype"]), device=run.device)
    model.load_state_dict(make_weights(cfg["model"], cfg["weights_seed"], run.device))
    return model
