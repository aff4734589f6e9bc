"""Generate the port's tutorial notebooks in ``cfm_tpu_torch/notebooks/``.

The torch counterparts of the nine notebooks of ``examples/notebooks/``:
the same sections in the same order, on the port's API, under the same file
names. Kept as a generator so the .ipynb files stay reproducible and
diff-able; rebuild them with

    python -m cfm_tpu_torch.gen_notebooks [--out DIR] [--only NAME]

which needs ``nbformat`` (imported inside :func:`main`). The notebooks are
written without outputs.

Each notebook keeps its sizes in one code cell tagged ``parameters``
(``DEVICE = "cuda"`` and the JAX notebook's step counts and batch sizes),
and imports matplotlib only in cells tagged ``plot``, so the other cells run
where matplotlib is not installed. :func:`execute` runs a notebook's code
cells in one namespace without Jupyter, the ``parameters`` cell's values
replaced by those given (as papermill injects them), the ``plot`` cells
skipped unless asked for:

    from cfm_tpu_torch.gen_notebooks import SMOKE, execute
    execute("cfm_tpu_torch/notebooks/flow_matching_tutorial.ipynb",
            dict(SMOKE["flow_matching_tutorial.ipynb"], DEVICE="cpu"))

``SMOKE`` holds each notebook's small sizes, the ones the tests run on the
CPU and ``chip_smoke.py`` runs on the card.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Iterable, List, Optional

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "notebooks")

Cell = Dict[str, object]


def md(src: str) -> Cell:
    return {"cell_type": "markdown", "source": src, "tags": []}


def code(src: str, *tags: str) -> Cell:
    return {"cell_type": "code", "source": src, "tags": list(tags)}


def parameters(src: str) -> Cell:
    return code(src, "parameters")


def plot(src: str) -> Cell:
    return code(src, "plot")


# ---------------------------------------------------------------------------
# 1. Flow matching tutorial: 8gaussians -> moons with I-CFM / OT-CFM / SB-CFM
# ---------------------------------------------------------------------------

FLOW_MATCHING = [
    md("""# Conditional flow matching on 2D toys: I-CFM, OT-CFM, SB-CFM

PyTorch counterpart of `examples/notebooks/flow_matching_tutorial.ipynb`
(after the reference tutorial `examples/2D_tutorials/Flow_matching_tutorial.ipynb`
in atong01/conditional-flow-matching): train a small MLP vector field to
transport 8 Gaussians onto two moons with three matchers, then compare the
learned flows.

On the card the minibatch OT coupling of OT-CFM and SB-CFM is one launch of
the dense auction kernel a step (`csrc/auction.cu`), and the W2 of the
generated points one launch of the tiled auction kernel
(`csrc/auction_tiled.cu`); with `DEVICE = "cpu"` the same cells run their
plain versions."""),
    code("""import numpy as np
import torch

from cfm_tpu_torch import (
    ConditionalFlowMatcher,
    ExactOptimalTransportConditionalFlowMatcher,
    SchrodingerBridgeConditionalFlowMatcher,
)
from cfm_tpu_torch.coupling import wasserstein
from cfm_tpu_torch.data import eight_gaussians, sample_moons
from cfm_tpu_torch.integrate import odeint, vector_field_from_model
from cfm_tpu_torch.models import MLP
from cfm_tpu_torch.train import ema_module, init_train_state, make_optimizer, make_train_step"""),
    parameters("""DEVICE = "cuda"   # "cpu" runs the kernels' plain versions
STEPS = 600       # training steps of each matcher
BATCH = 256
N = 1024          # generated points"""),
    md("""## Training loop

One function trains any matcher: sample a source/target minibatch, let the
matcher couple + sample `(t, x_t, u_t)`, regress the MLP on `u_t`. It
returns the MLP holding the EMA parameters."""),
    code("""def train(matcher, steps=STEPS, batch=BATCH, lr=2e-3, seed=0):
    model = MLP(dim=2, w=64, seed=seed, device=DEVICE)
    opt = make_optimizer(lr=lr, warmup_steps=0, grad_clip=1.0)
    state = init_train_state(model, opt)
    step = make_train_step(matcher, model, opt, ema_decay=0.99)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    for i in range(steps):
        x0 = eight_gaussians(gen, batch)
        x1 = sample_moons(gen, batch)
        metrics = step(state, x0, x1, generator=gen)
        if i % max(1, steps // 5) == 0:
            print(f"  step {i:4d}  loss {float(metrics['loss']):.4f}")
    return ema_module(model, state.ema_params)

matchers = {
    "I-CFM": ConditionalFlowMatcher(sigma=0.1),
    "OT-CFM": ExactOptimalTransportConditionalFlowMatcher(sigma=0.1),
    "SB-CFM": SchrodingerBridgeConditionalFlowMatcher(sigma=0.5),
}
trained = {}
for name, matcher in matchers.items():
    print(name)
    trained[name] = train(matcher)"""),
    md("""## Generation and trajectories

Integrate the learned fields from the source distribution with the euler
integrator and plot the sample paths."""),
    code("""gen = torch.Generator(device=DEVICE).manual_seed(42)
x0 = eight_gaussians(gen, N)
target = sample_moons(gen, N)
ts = np.linspace(0, 1, 101, dtype=np.float32)

paths = {}
for name, model in trained.items():
    with torch.inference_mode():
        sol = odeint(vector_field_from_model(model), x0, ts, method="euler")
    w2 = float(wasserstein(sol.final, target, power=2))
    paths[name] = (sol.ys.cpu().numpy(), w2)  # (T, n, 2)
    print(f"{name}: W2 = {w2:.3f}")"""),
    plot("""import matplotlib.pyplot as plt

fig, axes = plt.subplots(1, 3, figsize=(12, 4))
for ax, (name, (traj, w2)) in zip(axes, paths.items()):
    ax.plot(traj[:, :128, 0], traj[:, :128, 1], c="olive", lw=0.3, alpha=0.4)
    ax.scatter(traj[0, :, 0], traj[0, :, 1], s=3, c="black", label="x0")
    ax.scatter(traj[-1, :, 0], traj[-1, :, 1], s=3, c="blue", label="x1")
    ax.set_title(f"{name}  W2={w2:.3f}")
    ax.legend(loc="lower left", fontsize=7)
plt.tight_layout()
plt.show()"""),
    md("""OT-CFM's paths are visibly straighter than I-CFM's — the minibatch
OT coupling removes most of the conditional-path crossing, which is the
whole point (lower target variance, faster inference with fewer steps)."""),
]

# ---------------------------------------------------------------------------
# 2. SF2M tutorial: joint flow + score, ODE and SDE sampling
# ---------------------------------------------------------------------------

SF2M = [
    md("""# [SF]²M: simulation-free Schrödinger bridge matching

PyTorch counterpart of `examples/notebooks/SF2M_tutorial.ipynb` (after the
reference `SF2M_tutorial.ipynb`): jointly train a flow field `v(t, x)` and
a score field `s(t, x)` on the Brownian-bridge path of the
Schrödinger-bridge matcher, then sample with BOTH the probability-flow ODE
and the bridge SDE.

The score target uses the noise that generated `x_t` and the λ(t)
weighting (`compute_lambda`)."""),
    code("""import numpy as np
import torch

from cfm_tpu_torch import SchrodingerBridgeConditionalFlowMatcher
from cfm_tpu_torch.coupling import wasserstein
from cfm_tpu_torch.data import eight_gaussians, sample_moons
from cfm_tpu_torch.integrate import FlowSolver, vector_field_from_model
from cfm_tpu_torch.models import MLP
from cfm_tpu_torch.train import ema_module, init_train_state, make_optimizer, make_train_step"""),
    parameters("""DEVICE = "cuda"   # "cpu" runs the kernels' plain versions
STEPS = 800       # training steps
BATCH = 256
N = 1024          # generated points"""),
    code("""sigma = 0.5
matcher = SchrodingerBridgeConditionalFlowMatcher(sigma=sigma)
flow = MLP(dim=2, w=64, seed=0, device=DEVICE)
score = MLP(dim=2, w=64, seed=1, device=DEVICE)  # seeded apart from the flow head

opt = make_optimizer(lr=2e-3, warmup_steps=0, grad_clip=1.0)
state = init_train_state(flow, opt, score)
# score_model switches the step to the joint flow+score loss
# (flow MSE + mean((lambda_t * s + eps)^2), the reference's SF2M cell).
step = make_train_step(matcher, flow, opt, ema_decay=0.99, score_model=score)

gen = torch.Generator(device=DEVICE).manual_seed(0)
for i in range(STEPS):
    x0 = eight_gaussians(gen, BATCH)
    x1 = sample_moons(gen, BATCH)
    metrics = step(state, x0, x1, generator=gen)
    if i % max(1, STEPS // 5) == 0:
        print(f"step {i:4d}  loss {float(metrics['loss']):.4f}")"""),
    md("""## Sampling: probability-flow ODE vs bridge SDE

The `FlowSolver` mirrors the reference solver: ODE drift is `v`, the SDE
adds the score (`f = v + s`, diffusion `g = σ(t)`) integrated by
Euler–Maruyama with normals from a `torch.Generator`."""),
    code("""x0 = eight_gaussians(gen, N)
target = sample_moons(gen, N)
ts = np.linspace(0, 1, 101, dtype=np.float32)

n_flow = len(list(flow.parameters()))
f = vector_field_from_model(ema_module(flow, state.ema_params))
s = vector_field_from_model(ema_module(score, state.ema_params[n_flow:]))
solver = FlowSolver(drift=f, score=s, sigma=sigma)

with torch.inference_mode():
    ode = solver.odeint(x0, ts)
    sde = solver.sdeint(gen, x0, ts)
samples = {}
for label, xs in [("ODE", ode.final), ("SDE", sde.final)]:
    samples[label] = (xs.cpu().numpy(), float(wasserstein(xs, target, power=2)))
    print(f"{label}: W2 = {samples[label][1]:.3f}")"""),
    plot("""import matplotlib.pyplot as plt

tgt = target.cpu().numpy()
fig, axes = plt.subplots(1, 2, figsize=(9, 4))
for ax, (label, (xs, w2)) in zip(axes, samples.items()):
    ax.scatter(tgt[:, 0], tgt[:, 1], s=3, c="grey", alpha=0.4, label="target")
    ax.scatter(xs[:, 0], xs[:, 1], s=3, c="blue", label=label)
    ax.set_title(f"{label}  W2={w2:.3f}")
    ax.legend(fontsize=7)
plt.tight_layout()
plt.show()"""),
]

# ---------------------------------------------------------------------------
# 3. Maximum-likelihood CNF tutorial
# ---------------------------------------------------------------------------

CNF = [
    md("""# Exact-likelihood CNF: training and evaluation

PyTorch counterpart of `examples/notebooks/maximum_likelihood_CNF_tutorial.ipynb`
(after the reference `Maximum_likelihood_CNF_tutorial.ipynb`): instead of
regressing a conditional vector field, train the flow by maximizing exact
log-likelihood through the augmented (trace-carrying) ODE — and afterwards
evaluate `log p(x)` of held-out data with the same machinery.

The divergence is integrated as an extra channel of the ODE state
(`cfm_tpu_torch.augment.augmented_odeint`), the role of the reference's
`AugmentationModule` + `CNFReg`. `torch.optim.Adam` takes the place of
optax's `adam`."""),
    code("""import torch

from cfm_tpu_torch.augment import cnf_log_likelihood
from cfm_tpu_torch.data import sample_moons
from cfm_tpu_torch.models import MLP
from cfm_tpu_torch.variants import make_cnf_nll_loss"""),
    parameters("""DEVICE = "cuda"   # "cpu" runs on the host
STEPS = 300       # training steps
BATCH = 128
GRID = 60         # grid points a side of the log-likelihood landscape"""),
    code("""model = MLP(dim=2, w=64, seed=0, device=DEVICE)

# Negative log-likelihood loss: integrate x1 backward 1->0 with the exact
# trace; NLL = -[log N(x0) + int tr J dt].
nll_loss = make_cnf_nll_loss(model, n_steps=40, divergence="exact")
opt = torch.optim.Adam(model.parameters(), lr=2e-3)
gen = torch.Generator(device=DEVICE).manual_seed(0)

def train_step(x1):
    opt.zero_grad(set_to_none=True)
    loss, _ = nll_loss(gen, None, x1)
    loss.backward()
    opt.step()
    return loss.detach()

for i in range(STEPS):
    loss = train_step(sample_moons(gen, BATCH))
    if i % max(1, STEPS // 5) == 0:
        print(f"step {i:4d}  nll {float(loss):.4f}")"""),
    md("""## Log-likelihood landscape

Evaluate `log p(x)` on a grid: the learned CNF should put mass on the two
moons."""),
    code("""xs = torch.linspace(-1.5, 2.5, GRID, device=DEVICE)
ys = torch.linspace(-1.0, 1.5, GRID, device=DEVICE)
grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), -1).reshape(-1, 2)

def f(t, x):
    return model(torch.full((x.shape[0],), t, device=x.device), x)

with torch.no_grad():
    logp = cnf_log_likelihood(f, grid, n_steps=60, divergence="exact")
data = sample_moons(torch.Generator(device=DEVICE).manual_seed(7), 512)
print(f"log p on the grid: mean {float(logp.mean()):.3f}, max {float(logp.max()):.3f}")"""),
    plot("""import matplotlib.pyplot as plt

d = data.cpu().numpy()
plt.figure(figsize=(5, 4))
plt.imshow(torch.exp(logp).reshape(GRID, GRID).cpu().numpy(), origin="lower",
           extent=[-1.5, 2.5, -1.0, 1.5], cmap="viridis", aspect="auto")
plt.scatter(d[:, 0], d[:, 1], s=2, c="white", alpha=0.5)
plt.title("exp(log p(x)) of the trained CNF")
plt.colorbar()
plt.show()"""),
]

# ---------------------------------------------------------------------------
# 4. Conditional MNIST
# ---------------------------------------------------------------------------

COND_MNIST = [
    md("""# Class-conditional MNIST with guided OT-CFM

PyTorch counterpart of `examples/notebooks/conditional_mnist.ipynb` (after
the reference `examples/images/conditional_mnist.ipynb`): couple the
minibatch with exact OT **carrying the labels through the plan**
(`guided_sample_location_and_conditional_flow`), feed the label to the
UNet's class embedding, and generate digits row-by-row by class.

This cell uses the high-level `Trainer` harness; set `SYNTHETIC = False`
and put the MNIST idx files under `data/` to train on real digits. The
default settings are a fast smoke configuration — raise `STEPS` (2000+) and
the UNet width for real sample quality. On the card a step is one dense
auction launch (the coupling) and the UNet's GroupNorms run the GroupNorm
kernels forward and backward."""),
    code("""import torch

from cfm_tpu_torch.config import load_config
from cfm_tpu_torch.eval.plotting import image_grid
from cfm_tpu_torch.trainer import Trainer"""),
    parameters("""DEVICE = "cuda"     # "cpu" runs the kernels' plain versions
SYNTHETIC = True    # flip to False with real MNIST idx files under data/
STEPS = 30          # smoke default; use 2000+ for real digits
BATCH = 64
GEN_STEPS = 50      # euler steps of the generation
RESULTS = "results" # checkpoints, logs and samples go under RESULTS/nb_cond_mnist"""),
    code("""run_dir = f"{RESULTS}/nb_cond_mnist"
cfg = load_config("mnist_otcfm_cond", [
    f"trainer.total_steps={STEPS}",
    f"data.batch_size={BATCH}",
    f"data.synthetic_fallback={SYNTHETIC}",
    "model.num_channels=16",
    f"trainer.ckpt_dir={run_dir}/checkpoints",
])
trainer = Trainer(cfg, device=DEVICE, log_dir=f"{run_dir}/logs")
trainer.fit()"""),
    md("""## Generate one row per class

Pass the label vector to the solver; the UNet's class embedding steers each
trajectory to its digit."""),
    code("""gen = torch.Generator(device=trainer.device).manual_seed(1)
y = torch.arange(10).repeat_interleave(8)
out = trainer.generate(80, method="euler", n_steps=GEN_STEPS, y=y, generator=gen)
path = image_grid(out.images, nrow=8, save_path=f"{run_dir}/samples.png")
print("saved", path, "NFE", out.nfe)"""),
    plot("""from IPython.display import Image
Image(path)"""),
]


# ---------------------------------------------------------------------------
# 5. Minibatch-OT study: variance + straightness
# ---------------------------------------------------------------------------

OT_STUDY = [
    md("""# The (un)reasonable performance of minibatch OT

PyTorch counterpart of `examples/notebooks/minibatch_OT_study.ipynb` (after
the reference `The_unreasonable_performance_of_minibatch_OT.ipynb`): why
does re-pairing the minibatch by an OT plan help so much?

Two measurements: (1) the **variance of the regression target** — with
independent coupling, many different `u_t` values are seen at the same
`(t, x_t)`, so the MSE-optimal field averages crossing paths; OT coupling
collapses that variance; (2) the **straightness** of the learned flow
(the mean squared deviation of the generated paths from straight lines),
which controls how few inference steps you can get away with."""),
    code("""import torch

from cfm_tpu_torch import (
    ConditionalFlowMatcher,
    ExactOptimalTransportConditionalFlowMatcher,
)
from cfm_tpu_torch.coupling import OTPlanSampler
from cfm_tpu_torch.data import eight_gaussians, sample_moons
from cfm_tpu_torch.models import MLP
from cfm_tpu_torch.train import ema_module, init_train_state, make_optimizer, make_train_step
from cfm_tpu_torch.variants import straightness"""),
    parameters("""DEVICE = "cuda"   # "cpu" runs the kernels' plain versions
PLANS = 20        # minibatches of the variance study
BATCH = 256
STEPS = 600       # training steps of each matcher
N = 1024          # points of the straightness measurement"""),
    md("""## 1. Target variance at matched pairs

Sample many minibatches, record `(x_t, u_t)` at t=0.5, and compare the
spread of `u_t` for the nearest-neighbour `x_t` clusters under the two
couplings. A cheap proxy that needs no binning: the variance of `u_t`
itself — OT pairs nearby points, so `x1 - x0` concentrates."""),
    code("""gen = torch.Generator(device=DEVICE).manual_seed(0)
sampler = OTPlanSampler(method="exact")
u_ind, u_ot = [], []
for i in range(PLANS):
    x0 = eight_gaussians(gen, BATCH)
    x1 = sample_moons(gen, BATCH)
    u_ind.append(x1 - x0)                       # independent coupling
    x0p, x1p = sampler.sample_plan(gen, x0, x1)  # minibatch-OT coupling
    u_ot.append(x1p - x0p)
u_ind = torch.cat(u_ind); u_ot = torch.cat(u_ot)
print(f"Var[u_t] independent: {float(u_ind.var(correction=0)):.3f}")
print(f"Var[u_t] minibatch OT: {float(u_ot.var(correction=0)):.3f}")"""),
    md("""## 2. Straightness of the trained flows"""),
    code("""def train(matcher, steps=STEPS):
    model = MLP(dim=2, w=64, seed=1, device=DEVICE)
    opt = make_optimizer(lr=2e-3, warmup_steps=0)
    state = init_train_state(model, opt)
    step = make_train_step(matcher, model, opt, ema_decay=0.99)
    g = torch.Generator(device=DEVICE).manual_seed(1)
    for i in range(steps):
        step(state, eight_gaussians(g, BATCH), sample_moons(g, BATCH), generator=g)
    return ema_module(model, state.ema_params)

x_eval = eight_gaussians(torch.Generator(device=DEVICE).manual_seed(2), N)
results = {}
for name, matcher in [("I-CFM", ConditionalFlowMatcher(sigma=0.1)),
                      ("OT-CFM", ExactOptimalTransportConditionalFlowMatcher(sigma=0.1))]:
    model = train(matcher)
    with torch.no_grad():
        s = float(straightness(model, x_eval))
    results[name] = s
    print(f"{name}: straightness (lower = straighter) {s:.4f}")

assert results["OT-CFM"] < results["I-CFM"]"""),
    md("""OT-CFM's paths are straighter, which is exactly why it tolerates
few-step Euler inference — the reference notebook reaches the same
conclusion with torch + POT on the host; here the coupling of every
minibatch is one auction kernel launch on the card."""),
]


# ---------------------------------------------------------------------------
# 6. Model comparison plotting
# ---------------------------------------------------------------------------

MODEL_COMPARISON = [
    md("""# Model comparison: all five matchers side by side

PyTorch counterpart of `examples/notebooks/model_comparison_plotting.ipynb`
(after the reference `model-comparison-plotting.ipynb`): train every
matcher on the same 8gaussians -> moons task and render the generated
clouds and sample paths in one figure (the reference renders a GIF; a
static panel carries the same information)."""),
    code("""import numpy as np
import torch

from cfm_tpu_torch import (
    ConditionalFlowMatcher,
    ExactOptimalTransportConditionalFlowMatcher,
    SchrodingerBridgeConditionalFlowMatcher,
    TargetConditionalFlowMatcher,
    VariancePreservingConditionalFlowMatcher,
)
from cfm_tpu_torch.coupling import wasserstein
from cfm_tpu_torch.data import eight_gaussians, sample_moons
from cfm_tpu_torch.integrate import odeint, vector_field_from_model
from cfm_tpu_torch.models import MLP
from cfm_tpu_torch.train import ema_module, init_train_state, make_optimizer, make_train_step

MATCHERS = {
    "I-CFM": (ConditionalFlowMatcher(sigma=0.1), eight_gaussians),
    "OT-CFM": (ExactOptimalTransportConditionalFlowMatcher(sigma=0.1), eight_gaussians),
    "SB-CFM": (SchrodingerBridgeConditionalFlowMatcher(sigma=0.5), eight_gaussians),
    "FM (Lipman)": (TargetConditionalFlowMatcher(sigma=0.1), None),  # Gaussian source
    "VP-CFM": (VariancePreservingConditionalFlowMatcher(sigma=0.0), eight_gaussians),
}"""),
    parameters("""DEVICE = "cuda"   # "cpu" runs the kernels' plain versions
STEPS = 600       # training steps of each matcher
BATCH = 256
N = 1024          # generated points"""),
    code("""def source(source_fn, g, n):
    return source_fn(g, n) if source_fn else torch.randn((n, 2), generator=g, device=DEVICE)

def train(matcher, source_fn, steps=STEPS, batch=BATCH):
    model = MLP(dim=2, w=64, seed=0, device=DEVICE)
    opt = make_optimizer(lr=2e-3, warmup_steps=0)
    state = init_train_state(model, opt)
    step = make_train_step(matcher, model, opt, ema_decay=0.99)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    for i in range(steps):
        x0 = source(source_fn, g, batch)
        step(state, x0, sample_moons(g, batch), generator=g)
    return ema_module(model, state.ema_params)

trained = {}
for name, (matcher, src) in MATCHERS.items():
    print("training", name)
    trained[name] = (train(matcher, src), src)"""),
    code("""g = torch.Generator(device=DEVICE).manual_seed(7)
target = sample_moons(g, N)
ts = np.linspace(0, 1, 101, dtype=np.float32)

paths = {}
for name, (model, src) in trained.items():
    x0 = source(src, g, N)
    with torch.inference_mode():
        sol = odeint(vector_field_from_model(model), x0, ts, method="euler")
    w2 = float(wasserstein(sol.final, target, power=2))
    paths[name] = (sol.ys.cpu().numpy(), w2)
    print(f"{name}: W2 = {w2:.3f}")"""),
    plot("""import matplotlib.pyplot as plt

fig, axes = plt.subplots(1, len(paths), figsize=(4 * len(paths), 4))
for ax, (name, (traj, w2)) in zip(axes, paths.items()):
    ax.plot(traj[:, :96, 0], traj[:, :96, 1], c="olive", lw=0.2, alpha=0.5)
    ax.scatter(traj[-1, :, 0], traj[-1, :, 1], s=3, c="blue")
    ax.set_title(f"{name}\\nW2={w2:.3f}")
plt.tight_layout()
plt.show()"""),
]


# ---------------------------------------------------------------------------
# 7. Unconditional MNIST
# ---------------------------------------------------------------------------

MNIST_UNCOND = [
    md("""# Unconditional MNIST with OT-CFM

PyTorch counterpart of `examples/notebooks/mnist_example.ipynb` (after the
reference `examples/images/mnist_example.ipynb`): train the small UNet on
MNIST with exact-minibatch-OT coupling (on the card one dense auction
launch a step) and sample a digit grid by Euler integration.

The default settings are a fast smoke configuration on the synthetic
fallback set — flip `SYNTHETIC = False` with the MNIST idx files under
`data/` and raise `STEPS` (2000+) for real digits."""),
    code("""import torch

from cfm_tpu_torch.config import load_config
from cfm_tpu_torch.eval.plotting import image_grid
from cfm_tpu_torch.trainer import Trainer"""),
    parameters("""DEVICE = "cuda"     # "cpu" runs the kernels' plain versions
SYNTHETIC = True    # flip to False with real MNIST idx files under data/
STEPS = 30          # smoke default; use 2000+ for real digits
BATCH = 64
GEN_STEPS = 50      # euler steps of the sample grid
EVAL_N = 256        # images of the evaluation
RESULTS = "results" # checkpoints, logs and samples go under RESULTS/nb_mnist"""),
    code("""run_dir = f"{RESULTS}/nb_mnist"
cfg = load_config("mnist_otcfm", [
    f"trainer.total_steps={STEPS}",
    "trainer.eval_interval=0",
    f"data.batch_size={BATCH}",
    f"data.synthetic_fallback={SYNTHETIC}",
    "model.num_channels=16",
    f"trainer.ckpt_dir={run_dir}/checkpoints",
])
trainer = Trainer(cfg, device=DEVICE, log_dir=f"{run_dir}/logs")
trainer.fit()"""),
    md("""## Sample a grid

Integrate the learned field from Gaussian noise; `evaluate()` also reports
the weight-free tracking-FID against a held slice of the train set."""),
    code("""gen = torch.Generator(device=trainer.device).manual_seed(1)
out = trainer.generate(64, method="euler", n_steps=GEN_STEPS, generator=gen)
path = image_grid(out.images, nrow=8, save_path=f"{run_dir}/samples.png")
print("saved", path)
print("eval:", trainer.evaluate(n=EVAL_N))"""),
    plot("""from IPython.display import Image
Image(path)"""),
]


# ---------------------------------------------------------------------------
# 8. Single-cell trajectory interpolation
# ---------------------------------------------------------------------------

SINGLE_CELL = [
    md("""# Single-cell trajectory interpolation with OT-CFM

PyTorch counterpart of `examples/notebooks/single_cell_example.ipynb` (after
the reference `examples/single_cell/single-cell_example.ipynb`): interpolate
a multi-timepoint population (scRNA embryoid-body style) with OT-CFM, hold
out an intermediate timepoint, and score the interpolation with the
distribution-distance suite.

This notebook runs the synthetic branching TREE population so it executes
anywhere; point `load_h5ad_timeseries` at a real `.h5ad` (obsm `X_pca` +
`day` labels) for real data — `python -m cfm_tpu_torch.single_cell` is the
CLI twin."""),
    code("""import numpy as np
import torch

from cfm_tpu_torch import ExactOptimalTransportConditionalFlowMatcher
from cfm_tpu_torch.data.trajectory import (
    leaveout_adjusted_targets,
    make_joint_plan_sampler,
    resample_to_trajectory,
    sample_segment_pairs,
    tree_population,
)
from cfm_tpu_torch.eval.metrics import compute_distribution_distances
from cfm_tpu_torch.integrate import odeint
from cfm_tpu_torch.models import MLP
from cfm_tpu_torch.train import ema_module, init_train_state, make_optimizer
from cfm_tpu_torch.utils import ema_update"""),
    parameters("""DEVICE = "cuda"   # "cpu" runs the kernels' plain versions
N_CELLS = 1024    # cells a timepoint
STEPS = 400       # training steps
BATCH = 256
PAIRS = 512       # pairs drawn from the precomputed plans"""),
    code("""T, LEAVEOUT = 5, 2
gen = torch.Generator(device=DEVICE).manual_seed(0)
X = tree_population(gen, N_CELLS, T=T, dim=2)
marginals = [X[:, t] for t in range(T)]
print(f"{T} timepoints of {N_CELLS} cells, timepoint {LEAVEOUT} held out")"""),
    plot("""import matplotlib.pyplot as plt

fig, axes = plt.subplots(1, T, figsize=(3 * T, 3), sharex=True, sharey=True)
for t, ax in enumerate(axes):
    m = marginals[t].cpu().numpy()
    ax.scatter(m[:, 0], m[:, 1], s=2)
    ax.set_title(f"t = {t}" + ("  (held out)" if t == LEAVEOUT else ""))
plt.tight_layout(); plt.show()"""),
    md("""## Train on adjacent-segment pairs

Per sample: draw a random adjacent timepoint pair (never *starting* at the
held-out timepoint; the pair before it straddles to t+2), OT-couple within
the segment, regress the segment-local velocity. The straddling segment's
target halves and its local time doubles (`leaveout_adjusted_targets`).
The port's `make_optimizer` (Adam, clip 1.0) takes the place of optax."""),
    code("""matcher = ExactOptimalTransportConditionalFlowMatcher(sigma=0.1)
model = MLP(dim=2, w=64, seed=0, device=DEVICE)
opt = make_optimizer(lr=1e-3, warmup_steps=0)
state = init_train_state(model, opt)

def loss_fn(Xb):
    x0, x1, t_sel = sample_segment_pairs(gen, Xb, leaveout_timepoint=LEAVEOUT, training=True)
    t, xt, ut = matcher.sample_location_and_conditional_flow(gen, x0, x1)
    ut, t = leaveout_adjusted_targets(ut, t, t_sel, LEAVEOUT)
    vt = model(t + t_sel, xt)   # net sees global time
    return torch.mean(torch.square(vt - ut))

def step(Xb):
    loss = loss_fn(Xb)
    for p in state.params:
        p.grad = None
    loss.backward()
    opt.apply(state.params, [p.grad for p in state.params], state.opt_state)
    ema_update(state.ema_params, state.params, 0.99)
    state.step += 1
    return loss.detach()

for i in range(STEPS):
    Xb = resample_to_trajectory(gen, marginals, BATCH)
    loss = step(Xb)
    if i % max(1, STEPS // 4) == 0:
        print(f"step {i:4d}  loss {float(loss):.4f}")"""),
    md("""## Evaluate: roll through every timepoint

Integrate from t=0 marginal through all segments and score each predicted
marginal — including the held-out one the model never saw."""),
    code("""ema = ema_module(model, state.ema_params)

def f(t, x):
    return ema(torch.full((x.shape[0],), t, dtype=x.dtype, device=x.device), x)

x = marginals[0]
preds = []
with torch.inference_mode():
    for seg in range(T - 1):
        ts = np.linspace(float(seg), float(seg + 1), 51, dtype=np.float32)
        x = odeint(f, x, ts, method="rk4", return_trajectory=False).final
        preds.append(x)
trues = marginals[1:]
names, vals = compute_distribution_distances(preds, trues)
for n, v in zip(names, vals):
    if "Wasserstein" in n:
        print(f"  {n}: {v:.4f}")"""),
    plot("""import matplotlib.pyplot as plt

fig, ax = plt.subplots(figsize=(4, 4))
m = marginals[LEAVEOUT].cpu().numpy()
ax.scatter(m[:, 0], m[:, 1], s=3, c="grey", alpha=0.5, label="held-out truth")
p = preds[LEAVEOUT - 1].cpu().numpy()
ax.scatter(p[:, 0], p[:, 1], s=3, c="blue", alpha=0.5, label="interpolated")
ax.legend(); ax.set_title(f"held-out timepoint t={LEAVEOUT}")
plt.show()"""),
    md("""## Geodesic variant: precomputed joint plans

The reference's geodesic datamodule trains from plans computed once up
front (`adata.uns["pi_{t}_{t+1}"]`) instead of re-solving OT per batch.
`make_joint_plan_sampler` consumes them (inverse-CDF pair draws on the
device). Here the plans are solved once from the synthetic marginals."""),
    code("""from cfm_tpu_torch.coupling import OTPlanSampler

solver = OTPlanSampler(method="exact")
plans = [solver.get_map(marginals[t], marginals[t + 1]) for t in range(T - 1)]
plan_sample = make_joint_plan_sampler(marginals, plans)
x0p, x1p, t_sel = plan_sample(torch.Generator(device=DEVICE).manual_seed(3), PAIRS)
d_plan = float(torch.mean(torch.sum((x0p - x1p) ** 2, dim=1)))
print("mean squared pair distance under the precomputed plans:", round(d_plan, 4))"""),
]


# ---------------------------------------------------------------------------
# 9. Tabular Forest-Flow
# ---------------------------------------------------------------------------

TABULAR = [
    md("""# Forest-Flow: flow matching with gradient-boosted trees

PyTorch counterpart of `examples/notebooks/tabular_forest_flow.ipynb`
(after the reference `examples/tabular/*.ipynb`, Forest-Flow,
Jolicoeur-Martineau et al.): learn the I-CFM conditional vector field
`u_t = x1 - x0` at discretized time levels with a **tree ensemble**
instead of a neural net, then generate by Euler integration over the
per-level regressors.

The reference uses XGBoost; this notebook takes scikit-learn's
`HistGradientBoostingRegressor`, the same histogram-GBDT family, and needs
scikit-learn installed (it raises `ImportError` without it; the card's
machine has none). The port's role is the CFM path construction
(`sample_xt`) and the evaluation metrics — the trees themselves are
host-side by nature. `python -m cfm_tpu_torch.tabular_forest_flow` is the
CLI twin."""),
    code("""import numpy as np
import torch
from sklearn.datasets import load_iris
from sklearn.ensemble import HistGradientBoostingRegressor

from cfm_tpu_torch import ConditionalFlowMatcher
from cfm_tpu_torch.coupling import wasserstein"""),
    parameters("""DEVICE = "cuda"   # "cpu" runs on the host
N_T, DUP = 8, 10  # time levels / noise duplications (Forest-Flow K)
M, STEPS = 500, 60  # generated rows / Euler steps"""),
    code("""rng = np.random.default_rng(0)
X = load_iris().data.astype(np.float32)
mu, sd = X.mean(0), X.std(0) + 1e-8
X = (X - mu) / sd
n, d = X.shape
print(f"iris: {n} rows, {d} dims")"""),
    md("""## Fit one GBDT per (time level, output dim)

For each level `t_k`, pair every data point with `DUP` noise draws, build
`x_t` with the matcher's path (`sample_xt`), and regress `u = x1 - x0`."""),
    code("""FM = ConditionalFlowMatcher(sigma=0.0)
t_levels = np.linspace(0.0, 1.0, N_T, endpoint=False)
x1 = np.repeat(X, DUP, axis=0)
x0 = rng.standard_normal(x1.shape).astype(np.float32)
a, b = torch.from_numpy(x0).to(DEVICE), torch.from_numpy(x1).to(DEVICE)

models = []
for k, t in enumerate(t_levels):
    tb = torch.full((x1.shape[0],), float(t), device=DEVICE)
    xt = FM.sample_xt(a, b, tb, torch.zeros_like(a)).cpu().numpy()
    ut = x1 - x0
    models.append([
        HistGradientBoostingRegressor(max_iter=50, random_state=0).fit(xt, ut[:, j])
        for j in range(d)
    ])
print("fitted", N_T, "levels x", d, "dims")"""),
    md("""## Generate and evaluate

Euler over the piecewise-constant-in-time forest field, then compare the
synthetic marginals to the real ones."""),
    code("""x = rng.standard_normal((M, d)).astype(np.float32)
dt = 1.0 / STEPS
for s in range(STEPS):
    t = s * dt
    k = min(int(t * N_T), N_T - 1)
    u = np.stack([models[k][j].predict(x) for j in range(d)], axis=1)
    x = x + dt * u.astype(np.float32)

w2 = float(wasserstein(torch.from_numpy(x).to(DEVICE), torch.from_numpy(X).to(DEVICE),
                       power=2))
print(f"generated-vs-real W2: {w2:.4f}")"""),
    plot("""import matplotlib.pyplot as plt

fig, axes = plt.subplots(1, d, figsize=(3 * d, 3))
for j, ax in enumerate(axes):
    ax.hist(X[:, j], bins=20, alpha=0.5, density=True, label="real")
    ax.hist(x[:, j], bins=20, alpha=0.5, density=True, label="forest-flow")
    ax.set_title(load_iris().feature_names[j], fontsize=8)
axes[0].legend(fontsize=7)
plt.tight_layout(); plt.show()"""),
]


NOTEBOOKS: Dict[str, List[Cell]] = {
    "flow_matching_tutorial.ipynb": FLOW_MATCHING,
    "SF2M_tutorial.ipynb": SF2M,
    "maximum_likelihood_CNF_tutorial.ipynb": CNF,
    "conditional_mnist.ipynb": COND_MNIST,
    "mnist_example.ipynb": MNIST_UNCOND,
    "minibatch_OT_study.ipynb": OT_STUDY,
    "model_comparison_plotting.ipynb": MODEL_COMPARISON,
    "single_cell_example.ipynb": SINGLE_CELL,
    "tabular_forest_flow.ipynb": TABULAR,
}

# Each notebook's small sizes, for a run that only checks that every cell
# works (the CPU tests; ``chip_smoke.py`` on the card). The 2-D notebooks'
# generated clouds keep 768 points, the least at which their W2 takes the
# tiled auction kernel on the card (768 = 3 x 256 > 512).
SMOKE: Dict[str, Dict[str, object]] = {
    "flow_matching_tutorial.ipynb": dict(STEPS=20, BATCH=64, N=768),
    "SF2M_tutorial.ipynb": dict(STEPS=20, BATCH=64, N=768),
    "maximum_likelihood_CNF_tutorial.ipynb": dict(STEPS=3, BATCH=32, GRID=12),
    "conditional_mnist.ipynb": dict(STEPS=2, BATCH=8, GEN_STEPS=2),
    "mnist_example.ipynb": dict(STEPS=2, BATCH=8, GEN_STEPS=2, EVAL_N=8),
    "minibatch_OT_study.ipynb": dict(PLANS=2, BATCH=64, STEPS=150, N=256),
    "model_comparison_plotting.ipynb": dict(STEPS=10, BATCH=64, N=768),
    "single_cell_example.ipynb": dict(N_CELLS=768, STEPS=10, BATCH=64, PAIRS=64),
    "tabular_forest_flow.ipynb": dict(N_T=3, DUP=3, M=150, STEPS=10),
}


def cell_tags(cell: Dict) -> List[str]:
    """The tags of a cell of a notebook file (``metadata.tags``)."""
    return list(cell.get("metadata", {}).get("tags", []))


def execute(path: str, params: Optional[Dict[str, object]] = None,
            skip_tags: Iterable[str] = ("plot",)) -> Dict[str, object]:
    """Run the code cells of the notebook file ``path`` in order in one fresh
    namespace and return it. After the cell tagged ``parameters`` runs, the
    names of ``params`` are bound to its values; cells carrying a tag of
    ``skip_tags`` are skipped. Reads the file as JSON: no Jupyter needed."""
    with open(path) as fh:
        nb = json.load(fh)
    name = os.path.basename(path)
    ns: Dict[str, object] = {"__name__": "__main__"}
    skip = set(skip_tags)
    for i, cell in enumerate(nb["cells"]):
        if cell["cell_type"] != "code" or skip & set(cell_tags(cell)):
            continue
        src = "".join(cell["source"])
        exec(compile(src, f"<{name} cell {i}>", "exec"), ns)
        if "parameters" in cell_tags(cell) and params:
            ns.update(params)
    return ns


def build(name: str):
    """The nbformat notebook ``name``, its cell ids numbered in order."""
    import nbformat as nbf

    nb = nbf.v4.new_notebook()
    nb.metadata["kernelspec"] = {
        "display_name": "Python 3", "language": "python", "name": "python3",
    }
    for i, cell in enumerate(NOTEBOOKS[name]):
        meta = {"tags": cell["tags"]} if cell["tags"] else {}
        make = nbf.v4.new_markdown_cell if cell["cell_type"] == "markdown" else nbf.v4.new_code_cell
        nb.cells.append(make(cell["source"], id=f"cell-{i}", metadata=meta))
    return nb


def main(argv=None) -> List[str]:
    import nbformat as nbf

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=OUT, help="directory to write the notebooks to")
    ap.add_argument("--only", default=None, help="write only the notebooks whose name has this")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    written = []
    for name in NOTEBOOKS:
        if args.only and args.only not in name:
            continue
        path = os.path.join(args.out, name)
        nbf.write(build(name), path)
        written.append(path)
        print("wrote", path)
    return written


if __name__ == "__main__":
    main()
