"""Checkpoint save and restore of a ``TrainState`` (counterpart of
``cfm_tpu/checkpoint.py``).

The format is the port's own, not orbax's: one ``torch.save`` file a step,
``torch_step_<step>.pt``, holding plain CPU tensors, ints and lists (the
parameters, their EMA, Adam's count, mu and nu, the step and the parameter
shapes), so that it loads with ``torch.load(weights_only=True)``. A file is
written beside its final name and moved into place with ``os.replace``, so
a crash leaves the previous checkpoints whole. ``latest_step`` counts only
these files: an orbax step directory that the JAX package wrote into the
same directory is ignored.

Restoring loads the tensors onto the state's device (``map_location``) and
copies them into the state's own tensors, so the model whose parameters the
state holds sees them: a checkpoint saved on the card restores on the CPU,
and the other way round, bit for bit.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch

from cfm_tpu_torch.train import TrainState

FORMAT = "cfm_tpu_torch.TrainState/1"
_FILE = re.compile(r"^torch_step_(\d+)\.pt$")
_LISTS = ("params", "ema_params", "mu", "nu")


def _tensor_lists(state: TrainState) -> Dict[str, List[torch.Tensor]]:
    return {"params": list(state.params), "ema_params": list(state.ema_params),
            "mu": list(state.opt_state.mu), "nu": list(state.opt_state.nu)}


def save_train_state(path: str, state: TrainState) -> None:
    """Write ``state`` to the file ``path`` (atomically, through a temporary
    file in the same directory)."""
    lists = _tensor_lists(state)
    payload: Dict[str, Any] = {k: [t.detach().cpu() for t in v] for k, v in lists.items()}
    payload.update(format=FORMAT, step=int(state.step), count=int(state.opt_state.count),
                   shapes=[list(p.shape) for p in state.params])
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def restore_train_state(path: str, state_like: TrainState) -> TrainState:
    """Load the file ``path`` into ``state_like`` in place and return it.

    Raises ``ValueError`` when the file's tensors differ from the state's in
    number, shape or dtype (a checkpoint of another model)."""
    device = state_like.params[0].device
    payload = torch.load(path, map_location=device, weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"{path} is not a {FORMAT} checkpoint")
    lists = _tensor_lists(state_like)
    for key, dst in lists.items():
        src = payload[key]
        if len(src) != len(dst):
            raise ValueError(f"{path} holds {len(src)} {key} tensors, the state {len(dst)}")
        for i, (s, d) in enumerate(zip(src, dst)):
            if s.shape != d.shape or s.dtype != d.dtype:
                raise ValueError(f"{path}: {key}[{i}] is {s.dtype}{list(s.shape)}, the "
                                 f"state's {d.dtype}{list(d.shape)}")
    with torch.no_grad():
        for key, dst in lists.items():
            for s, d in zip(payload[key], dst):
                d.copy_(s)
    state_like.step = int(payload["step"])
    state_like.opt_state.count = int(payload["count"])
    return state_like


class CheckpointManager:
    """Save every ``save_interval`` steps, keep the latest ``max_to_keep``
    (0 or None: all), restore the latest (or a given) step."""

    def __init__(self, directory: str, save_interval: int = 20000, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.save_interval = save_interval
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"torch_step_{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_FILE.match, os.listdir(self.directory)) if m)

    def save(self, state: TrainState, force: bool = False, step: Optional[int] = None) -> bool:
        """Save when due (``step`` a multiple of ``save_interval``) or when
        ``force``d; a step already saved is not written again. ``step``
        defaults to ``state.step``, a host-side count (no device read).
        Returns whether a file was written."""
        step = int(state.step) if step is None else step
        if not force and (self.save_interval <= 0 or step % self.save_interval != 0):
            return False
        if step in self.all_steps():
            return False
        save_train_state(self.path(step), state)
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
        return True

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like: TrainState, step: Optional[int] = None) -> TrainState:
        """Restore ``step`` (default the latest) into ``state_like`` in place."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return restore_train_state(self.path(step), state_like)

    def close(self) -> None:
        """Nothing is left open between calls; kept for JAX's interface."""
