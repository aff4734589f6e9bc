"""Sweeps: grid multiruns, random search and a TPE hyperparameter search
over the port's config and ``Trainer`` (counterpart of ``cfm_tpu/sweep.py``).

Each spec value like ``"matcher.kind=icfm,otcfm"`` expands into the
cartesian product of runs; runs execute one after another, and a failed run
is recorded (error and traceback) and the sweep goes on. ``run_fn(cfg) ->
metrics`` defaults to training the config's ``Trainer`` on the card and
evaluating it.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import random
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from cfm_tpu_torch.config import Config, load_config


def expand_grid(overrides: Sequence[str]) -> List[List[str]]:
    """Expand comma-valued overrides into the cartesian product of runs.

    ["a.b=1,2", "c.d=x"] -> [["a.b=1","c.d=x"], ["a.b=2","c.d=x"]]
    """
    groups = []
    for ov in overrides:
        key, vals = ov.split("=", 1)
        groups.append([f"{key}={v}" for v in vals.split(",")])
    return [list(combo) for combo in itertools.product(*groups)]


def run_sweep(
    preset: str,
    overrides: Sequence[str],
    run_fn: Optional[Callable[[Config], Dict[str, float]]] = None,
    metric: str = "w2",
) -> List[Dict]:
    """Grid multirun. ``run_fn(cfg) -> metrics dict``; default trains the
    harness Trainer and evaluates. Returns one record per run with its
    overrides, metrics, and any error."""
    if run_fn is None:
        def run_fn(cfg):
            from cfm_tpu_torch.trainer import Trainer

            t = Trainer(cfg)
            t.fit()
            return t.evaluate()

    records = []
    for combo in expand_grid(overrides):
        rec: Dict = {"overrides": combo}
        try:
            cfg = load_config(preset, combo)
            cfg.name = f"{cfg.name}_" + "_".join(c.split("=")[1] for c in combo)[:60]
            rec["metrics"] = run_fn(cfg)
            rec["objective"] = rec["metrics"].get(metric)
        except Exception as e:  # sweep resilience: record, continue
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()
        records.append(rec)
    return records


def random_search(
    preset: str,
    space: Dict[str, Callable[[random.Random], object]],
    n_trials: int,
    run_fn: Optional[Callable[[Config], Dict[str, float]]] = None,
    metric: str = "w2",
    minimize: bool = True,
    seed: int = 0,
) -> Tuple[Dict, List[Dict]]:
    """Random hparam search (the optuna-config role with zero dependencies).

    ``space`` maps override keys to samplers, e.g.
        {"optim.lr": lambda r: 10 ** r.uniform(-4.5, -2.5)}
    Returns (best record, all records).
    """
    rng = random.Random(seed)
    trials = []
    for _ in range(n_trials):
        combo = [f"{k}={sampler(rng)}" for k, sampler in space.items()]
        trials.append(run_sweep(preset, combo, run_fn=run_fn, metric=metric)[0])
    scored = [t for t in trials if t.get("objective") is not None]
    if not scored:
        return {}, trials
    best = (min if minimize else max)(scored, key=lambda t: t["objective"])
    return best, trials


def log_uniform(lo: float, hi: float) -> Callable[[random.Random], float]:
    return lambda r: 10 ** r.uniform(math.log10(lo), math.log10(hi))


def choice(*options) -> Callable[[random.Random], object]:
    return lambda r: r.choice(options)


# --------------------------------------------------------------------------
# TPE search (the reference's optuna.yaml sampler: optuna TPESampler)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Float:
    """Continuous search dimension; ``log=True`` searches in log10 space."""

    lo: float
    hi: float
    log: bool = False

    def to_internal(self, v: float) -> float:
        return math.log10(v) if self.log else v

    def from_internal(self, u: float) -> float:
        lo, hi = self.bounds()
        u = min(max(u, lo), hi)
        return 10 ** u if self.log else u

    def bounds(self) -> Tuple[float, float]:
        if self.log:
            return math.log10(self.lo), math.log10(self.hi)
        return self.lo, self.hi


@dataclasses.dataclass(frozen=True)
class Categorical:
    options: tuple

    def __init__(self, *options):
        for o in options:
            if isinstance(o, str) and "," in o:
                # Sampled values round-trip through run_sweep's comma-grid
                # expansion; a comma inside an option would be silently
                # re-split into multiple runs and only the first kept, so
                # the TPE history would record values that never ran.
                raise ValueError(
                    f"Categorical option {o!r} contains a comma — commas are"
                    " the sweep grid separator; encode lists differently"
                    " (e.g. '64x64')"
                )
        object.__setattr__(self, "options", tuple(options))


def _parzen_bandwidths(obs: List[float], lo: float, hi: float) -> List[float]:
    """Per-observation bandwidths via the neighbor-spacing heuristic of
    Bergstra et al. 2011: sigma_i = max gap to the adjacent observations
    (with virtual neighbors at the bounds), clipped to [1%, 50%] of the
    domain width. Narrow where observations cluster (exploitation), wide
    where they are sparse (exploration)."""
    width = hi - lo
    order = sorted(range(len(obs)), key=lambda i: obs[i])
    sigmas = [0.0] * len(obs)
    for rank, i in enumerate(order):
        x = obs[i]
        left = obs[order[rank - 1]] if rank > 0 else lo
        right = obs[order[rank + 1]] if rank + 1 < len(order) else hi
        # Positional (not value-keyed): duplicate observations each keep
        # their true neighbor-gap bandwidth instead of the last duplicate's.
        sigmas[i] = min(max(max(x - left, right - x), 0.01 * width), 0.5 * width)
    return sigmas


def _parzen_logpdf(x: float, obs: List[float], sigmas: List[float],
                   lo: float, hi: float) -> float:
    """Log density of a Parzen mixture over ``obs`` with a uniform prior
    component (optuna's prior_weight=1.0 convention keeps the estimator
    proper when one side has few observations)."""
    width = hi - lo
    comps = [1.0 / width]  # uniform prior component
    for mu, sigma in zip(obs, sigmas):
        z = (x - mu) / sigma
        comps.append(math.exp(-0.5 * z * z) / (sigma * math.sqrt(2 * math.pi)))
    return math.log(sum(comps) / (len(obs) + 1))


def _tpe_sample_float(
    rng: random.Random, dim: Float, good: List[float], bad: List[float],
    n_candidates: int,
) -> float:
    lo, hi = dim.bounds()
    n = len(good)
    sig_l = _parzen_bandwidths(good, lo, hi)
    sig_g = _parzen_bandwidths(bad, lo, hi)
    best_x, best_score = None, -math.inf
    for _ in range(n_candidates):
        # Draw from l(x): pick a good observation (or the prior) and jitter.
        if good and rng.random() > 1.0 / (n + 1):
            i = rng.randrange(n)
            x = rng.gauss(good[i], sig_l[i])
        else:
            x = rng.uniform(lo, hi)
        x = min(max(x, lo), hi)
        score = (_parzen_logpdf(x, good, sig_l, lo, hi)
                 - _parzen_logpdf(x, bad, sig_g, lo, hi))
        if score > best_score:
            best_x, best_score = x, score
    return dim.from_internal(best_x)


def _tpe_sample_categorical(
    rng: random.Random, dim: Categorical, good: List[object], bad: List[object],
) -> object:
    # Weighted-count ratio with add-one smoothing (optuna's categorical TPE).
    best_opt, best_score = None, -math.inf
    for opt in dim.options:
        l = (1.0 + sum(1 for g in good if g == opt)) / (len(dim.options) + len(good))
        g = (1.0 + sum(1 for b in bad if b == opt)) / (len(dim.options) + len(bad))
        score = math.log(l / g) + 1e-6 * rng.random()  # tie-break
        if score > best_score:
            best_opt, best_score = opt, score
    return best_opt


def tpe_search(
    preset: str,
    space: Dict[str, object],
    n_trials: int,
    run_fn: Optional[Callable[[Config], Dict[str, float]]] = None,
    metric: str = "w2",
    minimize: bool = True,
    seed: int = 0,
    n_startup: int = 5,
    gamma: float = 0.25,
    n_candidates: int = 24,
) -> Tuple[Dict, List[Dict]]:
    """Tree-structured Parzen Estimator search (Bergstra et al. 2011), the
    algorithm behind the reference's optuna config
    (runner/configs/hparams_search/optuna.yaml).

    ``space`` maps override keys to :class:`Float` / :class:`Categorical`
    dimensions. The first ``n_startup`` trials are random; afterwards each
    trial splits history at the ``gamma`` quantile into good/bad sets, fits
    Parzen mixtures l(x) (good) and g(x) (bad) per dimension, and picks the
    candidate maximizing l(x)/g(x). Returns (best record, all records);
    failed trials are recorded and skipped by the estimator.
    """
    rng = random.Random(seed)
    trials: List[Dict] = []
    history: List[Tuple[Dict[str, object], float]] = []  # (internal params, objective)

    for i in range(n_trials):
        params: Dict[str, object] = {}
        scored = sorted(history, key=lambda h: h[1], reverse=not minimize)
        use_tpe = len(scored) >= n_startup
        n_good = max(1, int(math.ceil(gamma * len(scored)))) if scored else 0
        for key, dim in space.items():
            if isinstance(dim, Float):
                if use_tpe:
                    good = [h[0][key] for h in scored[:n_good]]
                    bad = [h[0][key] for h in scored[n_good:]]
                    val = _tpe_sample_float(rng, dim, good, bad, n_candidates)
                else:
                    lo, hi = dim.bounds()
                    val = dim.from_internal(rng.uniform(lo, hi))
                params[key] = val
            elif isinstance(dim, Categorical):
                if use_tpe:
                    good = [h[0][key] for h in scored[:n_good]]
                    bad = [h[0][key] for h in scored[n_good:]]
                    params[key] = _tpe_sample_categorical(rng, dim, good, bad)
                else:
                    params[key] = rng.choice(dim.options)
            else:
                raise TypeError(f"space[{key!r}] must be Float or Categorical")
        combo = [f"{k}={v}" for k, v in params.items()]
        rec = run_sweep(preset, combo, run_fn=run_fn, metric=metric)[0]
        rec["trial"] = i
        rec["params"] = params
        trials.append(rec)
        if rec.get("objective") is not None:
            internal = {
                k: (space[k].to_internal(v) if isinstance(space[k], Float) else v)
                for k, v in params.items()
            }
            history.append((internal, float(rec["objective"])))

    done = [t for t in trials if t.get("objective") is not None]
    if not done:
        return {}, trials
    best = (min if minimize else max)(done, key=lambda t: t["objective"])
    return best, trials
