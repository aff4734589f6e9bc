"""Configuration: the JAX package's dataclasses field for field, its presets
(``2d_*``, ``cifar10_*`` and ``mnist_*`` for the five matchers, ``2d_sf2m``
and ``mnist_otcfm_cond``), dotted ``key=value`` overrides, the ``debug=``
overlays and YAML files (counterpart of ``cfm_tpu/config.py``).

``load_config("2d_otcfm", ["optim.lr=1e-3", "trainer.total_steps=1000"])``
``load_config("configs/experiment/cifar10_otcfm.yaml", ["debug=fdr"])``

``2d_sf2m`` is [SF]2M: SB-CFM at sigma 1 with a score head, whose
coupling is the exact plan unless ``matcher.ot_method=sinkhorn`` (the
entropic plan of reg 2 sigma^2). ``eval.sde`` adds the SDE metrics of a
score head to an evaluation; ``model.use_checkpoint`` (with
``model.checkpoint_policy`` None, "dots" or "dots_no_batch") recomputes
the UNet's blocks in the backward. ``yaml`` is imported only by the YAML
functions.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


@dataclass
class ModelConfig:
    kind: str = "mlp"                # mlp | unet
    width: int = 64                  # the MLP's hidden width
    hidden_dims: Tuple[int, ...] = (64, 64, 64)
    activation: str = "selu"
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
    use_checkpoint: bool = False     # activation checkpointing of the UNet's blocks
    # What a checkpointed block saves: None (nothing) | "dots" | "dots_no_batch".
    checkpoint_policy: Optional[str] = None
    bf16: bool = True


@dataclass
class MatcherConfig:
    kind: str = "otcfm"              # icfm | otcfm | fm | sbcfm | vpcfm
    sigma: float = 0.0
    ot_method: str = "exact"         # sbcfm's coupling: exact | sinkhorn
    score_head: bool = False         # [SF]2M's score head


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
    eval_interval: int = 5000
    ckpt_dir: str = "checkpoints"    # checkpoints go to <ckpt_dir>/<name>
    ckpt_interval: int = 20000
    resume: bool = True              # restore the latest checkpoint on construction
    # Under an initialised process group of several ranks (torchrun), the
    # replicated-coupling data-parallel step; one process trains alone.
    data_parallel: bool = True
    # A sample grid of sample_grid_n images, as <ckpt_dir>/<name>/samples_<step>.png,
    # every N steps of an image run (0: off).
    sample_grid_interval: int = 0
    sample_grid_n: int = 64
    # Early stopping on an evaluation metric (mode min), checked at every
    # evaluation; "" disables. Patience counts evaluations without improvement.
    early_stop_metric: str = ""
    early_stop_patience: int = 3
    early_stop_min_delta: float = 0.0
    # Debugging aids (the debug= overlays): the data draws cycle through N
    # fixed batches (noise, t and dropout stay fresh); a torch.profiler trace
    # of each fit under profile_dir ("": off); autograd's anomaly mode for
    # the fit, restored after it.
    overfit_batches: int = 0
    profile_dir: str = ""
    debug_nans: bool = False


@dataclass
class EvalConfig:
    ode_method: str = "dopri5"
    ode_steps: int = 100             # for fixed-step generation
    num_eval_samples: int = 2048
    sde: bool = False                # with a score head: sde_kl (and sde_w2 on 2-D)


@dataclass
class Config:
    name: str = "experiment"
    model: ModelConfig = field(default_factory=ModelConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def tree_str(self) -> str:
        """The config as a plain-text tree, ``config: <name>`` first."""
        lines = [f"config: {self.name}"]

        def walk(d: Dict[str, Any], indent: str) -> None:
            items = list(d.items())
            for i, (k, v) in enumerate(items):
                last = i == len(items) - 1
                branch = "`-- " if last else "|-- "
                if isinstance(v, dict):
                    lines.append(f"{indent}{branch}{k}")
                    walk(v, indent + ("    " if last else "|   "))
                else:
                    lines.append(f"{indent}{branch}{k} = {v!r}")

        d = self.to_dict()
        d.pop("name", None)
        walk(d, "")
        return "\n".join(lines)


def _preset_2d(matcher: str, **kw) -> Config:
    """The 2-D tutorial, as ``cfm_tpu/config.py:_preset_2d``: 8 Gaussians (a
    standard normal for the target FM, whose path ignores x0) to moons, a
    width-64 MLP, batch 256, Adam 2e-3 without warmup, EMA 0.99, 5000
    steps, W1/W2 on 2048 points every 1000. ``kw`` are matcher fields
    (sigma defaults to 0.1)."""
    return Config(
        name=f"2d_{matcher}",
        model=ModelConfig(kind="mlp", width=64),
        matcher=MatcherConfig(kind=matcher, sigma=kw.pop("sigma", 0.1), **kw),
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
PRESETS["2d_sf2m"] = lambda: _preset_2d("sbcfm", sigma=1.0, score_head=True)
PRESETS["mnist_otcfm_cond"] = lambda: _preset_mnist("otcfm", class_cond=True)


def available_presets() -> List[str]:
    return sorted(PRESETS)


DEBUG_MODES = ("default", "fdr", "limit", "overfit", "profiler")


def apply_debug(cfg: Config, mode: str) -> Config:
    """Apply a debug overlay in place and return ``cfg``, as JAX's
    ``apply_debug``: every mode prefixes the name with ``debug_`` and turns
    ``debug_nans`` on (but the profiler's); ``default`` runs at most 100
    steps, ``fdr`` one step and one evaluation, ``limit`` 1% of the steps,
    ``overfit`` cycles 3 data batches without evaluations, ``profiler``
    traces at most 100 steps into ``logs/profile_<name>``."""
    if mode not in DEBUG_MODES:
        raise ValueError(f"Unknown debug mode {mode!r}; one of {DEBUG_MODES}")
    t = cfg.trainer
    cfg.name = f"debug_{cfg.name}"
    t.debug_nans = True
    if mode == "default":
        t.total_steps = min(t.total_steps, 100)
        t.eval_interval = min(t.eval_interval, t.total_steps) if t.eval_interval else 0
        t.log_interval = min(t.log_interval, max(t.total_steps // 4, 1))
    elif mode == "fdr":
        t.total_steps = 1
        t.eval_interval = 1
        t.log_interval = 1
    elif mode == "limit":
        t.total_steps = max(t.total_steps // 100, 1)
        t.eval_interval = min(t.eval_interval, t.total_steps) if t.eval_interval else 0
        t.log_interval = min(t.log_interval, max(t.total_steps // 10, 1))
    elif mode == "overfit":
        t.overfit_batches = 3
        t.total_steps = min(t.total_steps, 2000)
        t.eval_interval = 0
        t.early_stop_metric = ""
        t.log_interval = min(t.log_interval, max(t.total_steps // 10, 1))
    elif mode == "profiler":
        t.debug_nans = False         # anomaly checks would distort the trace
        t.total_steps = min(t.total_steps, 100)
        t.eval_interval = 0
        t.log_interval = min(t.log_interval, max(t.total_steps // 4, 1))
        t.profile_dir = f"logs/profile_{cfg.name}"
    return cfg


def load_config(preset: Optional[str] = None, overrides: Sequence[str] = ()) -> Config:
    """A preset, or a ``.yaml``/``.yml`` file (or any path with a ``/``),
    with ``group.field=value`` overrides (values literal-eval'd).

    A YAML file may name its base preset under ``preset:``; the command
    line applies on top of it. ``debug=<mode>`` overlays apply before the
    other overrides, and ``name=`` before the overlays, which prefix it.
    """
    if preset and (preset.endswith((".yaml", ".yml")) or "/" in preset):
        cfg = _load_yaml_config(preset)
    else:
        cfg = _preset(preset) if preset else Config()
    debug_modes, rest = [], []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override must be key=value, got {ov!r}")
        path, raw = (s.strip() for s in ov.split("=", 1))
        if path == "debug":
            debug_modes.append(raw)
        elif path == "name":
            _apply_override(cfg, path, raw)
        else:
            rest.append((path, raw))
    for mode in debug_modes:
        apply_debug(cfg, mode)
    for path, raw in rest:
        _apply_override(cfg, path, raw)
    return cfg


def _preset(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; one of {available_presets()}")
    return PRESETS[name]()


def _flatten(d: Dict[str, Any], prefix: str = "") -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    for k, v in d.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.extend(_flatten(v, path))
        else:
            out.append((path, v))
    return out


def _load_yaml_config(path: str) -> Config:
    """A Config from a YAML mapping: ``preset:`` (the base), ``name:``,
    ``debug:`` and nested fields, applied in that order."""
    import yaml

    with open(path) as fh:
        doc = yaml.safe_load(fh) or {}
    if not isinstance(doc, dict):
        raise ValueError(f"YAML config must be a mapping, got {type(doc).__name__}")
    base = doc.pop("preset", None)
    debug_mode = doc.pop("debug", None)
    cfg = _preset(base) if base else Config()
    name = doc.pop("name", None)
    if name is not None:
        cfg.name = str(name)
    if debug_mode:
        apply_debug(cfg, str(debug_mode))
    for dotted, value in _flatten(doc):
        _apply_value(cfg, dotted, value)
    return cfg


def save_config(cfg: Config, path: str) -> None:
    """Write ``cfg`` as YAML; ``load_config(path)`` reads it back."""
    import yaml

    def clean(v):
        if isinstance(v, tuple):
            return [clean(x) for x in v]
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()}
        return v

    with open(path, "w") as fh:
        yaml.safe_dump(clean(cfg.to_dict()), fh, sort_keys=False)


def _apply_override(cfg: Any, path: str, raw: str) -> None:
    try:
        value = ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        value = raw  # bare string
    _apply_value(cfg, path, value)


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
