"""Configuration: the fields the trainer reads, the JAX package's presets
(``2d_*``, ``cifar10_*`` and ``mnist_*`` for the five matchers, and
``mnist_otcfm_cond``) and dotted ``key=value`` overrides (counterpart of
``cfm_tpu/config.py``).

``load_config("2d_otcfm", ["optim.lr=1e-3", "trainer.total_steps=1000"])``

``2d_sf2m`` (SB-CFM with a score head) waits for the score-head loss
(ROADMAP.md queue 1 item 6); YAML files and the debug overlays for queue 1
item 9.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


@dataclass
class ModelConfig:
    kind: str = "mlp"                # mlp | unet
    width: int = 64                  # the MLP's hidden width
    image_dim: Tuple[int, int, int] = (32, 32, 3)   # (H, W, C)
    num_channels: int = 128
    num_res_blocks: int = 2
    channel_mult: Optional[Tuple[float, ...]] = None
    num_heads: int = 4
    num_head_channels: int = 64
    attention_resolutions: str = "16"
    dropout: float = 0.1
    use_scale_shift_norm: bool = False
    resblock_updown: bool = False
    class_cond: bool = False
    num_classes: int = 10
    bf16: bool = True


@dataclass
class MatcherConfig:
    kind: str = "otcfm"              # icfm | otcfm | fm | sbcfm | vpcfm
    sigma: float = 0.0
    ot_method: str = "exact"         # sbcfm's coupling; "sinkhorn" is not ported
    score_head: bool = False         # [SF]2M's score head: not ported, refused


@dataclass
class DataConfig:
    dataset: str = "moons"           # a 2-D generator's name | cifar10 | mnist
    source: str = "8gaussians"       # the 2-D source distribution
    dim: int = 0                     # gaussian/funnel's dimension; 0: the generator's default
    data_dir: str = "data"
    batch_size: int = 256
    synthetic_fallback: bool = True  # the synthetic set when none is on disk
    random_flip: bool = True
    # The whole uint8 set on the card, batches gathered per step.
    on_device: bool = True


@dataclass
class OptimConfig:
    lr: float = 2e-4
    warmup_steps: int = 5000
    grad_clip: float = 1.0
    ema_decay: float = 0.9999
    weight_decay: float = 0.0


@dataclass
class TrainerConfig:
    total_steps: int = 400001
    seed: int = 0
    log_interval: int = 100
    eval_interval: int = 5000        # the image branch's evaluation is not ported: fit raises
    ckpt_interval: int = 20000       # checkpointing is not ported: fit raises if one is due
    data_parallel: bool = True       # the mesh is not ported: raises with more than one card
    # Early stopping on an evaluation metric (mode min), checked at every
    # evaluation; "" disables. Patience counts evaluations without improvement.
    early_stop_metric: str = ""
    early_stop_patience: int = 3
    early_stop_min_delta: float = 0.0


@dataclass
class EvalConfig:
    """Generation and evaluation settings (the 2-D branch's W1/W2; the image
    branch's evaluation waits for ROADMAP.md queue 1 item 4)."""

    ode_method: str = "dopri5"
    ode_steps: int = 100             # for fixed-step generation
    num_eval_samples: int = 2048


@dataclass
class Config:
    name: str = "experiment"
    model: ModelConfig = field(default_factory=ModelConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)


def _preset_2d(matcher: str) -> Config:
    """The 2-D tutorial, as ``cfm_tpu/config.py:_preset_2d``: 8 Gaussians (a
    standard normal for the target FM, whose path ignores x0) to moons, a
    width-64 MLP, batch 256, Adam 2e-3 without warmup, EMA 0.99, 5000
    steps, W1/W2 on 2048 points every 1000."""
    return Config(
        name=f"2d_{matcher}",
        model=ModelConfig(kind="mlp", width=64),
        matcher=MatcherConfig(kind=matcher, sigma=0.1),
        data=DataConfig(dataset="moons", source="gaussian" if matcher == "fm" else "8gaussians",
                        batch_size=256),
        optim=OptimConfig(lr=2e-3, warmup_steps=0, ema_decay=0.99),
        trainer=TrainerConfig(total_steps=5000, eval_interval=1000, ckpt_interval=5000,
                              data_parallel=False),
        eval=EvalConfig(ode_method="euler", num_eval_samples=2048),
    )


def _preset_cifar10(matcher: str) -> Config:
    """The reference headline recipe, as ``cfm_tpu/config.py:_preset_cifar10``."""
    return Config(
        name=f"cifar10_{matcher}",
        model=ModelConfig(kind="unet", image_dim=(32, 32, 3), num_channels=128,
                          num_res_blocks=2, channel_mult=(1, 2, 2, 2), num_heads=4,
                          num_head_channels=64, attention_resolutions="16", dropout=0.1),
        matcher=MatcherConfig(kind=matcher, sigma=0.0),
        data=DataConfig(dataset="cifar10", source="gaussian", batch_size=128),
        optim=OptimConfig(lr=2e-4, warmup_steps=5000, grad_clip=1.0, ema_decay=0.9999),
        trainer=TrainerConfig(total_steps=400001, ckpt_interval=20000),
        eval=EvalConfig(ode_method="dopri5"),
    )


def _preset_mnist(matcher: str, class_cond: bool = False) -> Config:
    """The MNIST presets, as ``cfm_tpu/config.py:_preset_mnist``: a 32-channel
    UNet at 28x28 (mult (1, 2, 2), one res block, attention at 14x14), no
    dropout, batch 128; ``class_cond`` adds the 10-class label embedding."""
    return Config(
        name=f"mnist_{matcher}" + ("_cond" if class_cond else ""),
        model=ModelConfig(kind="unet", image_dim=(28, 28, 1), num_channels=32,
                          num_res_blocks=1, num_heads=1, num_head_channels=-1,
                          attention_resolutions="14", dropout=0.0, class_cond=class_cond),
        matcher=MatcherConfig(kind=matcher, sigma=0.0),
        data=DataConfig(dataset="mnist", source="gaussian", batch_size=128),
        optim=OptimConfig(lr=2e-4, warmup_steps=500, ema_decay=0.999),
        trainer=TrainerConfig(total_steps=20000, ckpt_interval=5000),
        eval=EvalConfig(ode_method="euler"),
    )


PRESETS: Dict[str, Callable[[], Config]] = {}
for _m in ("icfm", "otcfm", "fm", "sbcfm", "vpcfm"):
    PRESETS[f"2d_{_m}"] = lambda m=_m: _preset_2d(m)
    PRESETS[f"cifar10_{_m}"] = lambda m=_m: _preset_cifar10(m)
    PRESETS[f"mnist_{_m}"] = lambda m=_m: _preset_mnist(m)
PRESETS["mnist_otcfm_cond"] = lambda: _preset_mnist("otcfm", class_cond=True)


def available_presets() -> List[str]:
    return sorted(PRESETS)


def load_config(preset: Optional[str] = None, overrides: Sequence[str] = ()) -> Config:
    """A preset with ``group.field=value`` overrides (values literal-eval'd)."""
    if preset == "2d_sf2m":
        raise NotImplementedError("preset '2d_sf2m': the score head and its loss are not ported "
                                  "yet (ROADMAP.md queue 1 item 6)")
    if preset is not None and preset not in PRESETS:
        raise NotImplementedError(f"preset {preset!r} is not ported yet (ROADMAP.md queue 1 "
                                  f"item 9); the port has {available_presets()}")
    cfg = PRESETS[preset]() if preset else Config()
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override must be key=value, got {ov!r}")
        path, raw = (s.strip() for s in ov.split("=", 1))
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw  # bare string
        _apply_value(cfg, path, value)
    return cfg


def _apply_value(cfg: Any, path: str, value: Any) -> None:
    *groups, leaf = path.split(".")
    obj = cfg
    for p in groups:
        if not hasattr(obj, p):
            raise AttributeError(f"No config group {p!r} in {path!r}")
        obj = getattr(obj, p)
    if not hasattr(obj, leaf):
        raise AttributeError(f"No config field {leaf!r} in {path!r}")
    current = getattr(obj, leaf)
    if current is not None and not isinstance(value, type(current)):
        if isinstance(current, float) and isinstance(value, int):
            value = float(value)
        elif isinstance(current, tuple) and isinstance(value, (list, tuple)):
            value = tuple(value)
        elif isinstance(current, bool) and isinstance(value, str):
            value = value.lower() in ("1", "true", "yes")
    setattr(obj, leaf, value)
