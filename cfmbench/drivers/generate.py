"""Generation traffic: the program's ``generate.generate``, closed loop,
one batch after another, as the FID protocol draws its 50k images.

Traffic keys: ``batch``, ``method`` ("euler" or "dopri5"), ``n_steps``
(euler), ``rtol`` / ``atol`` (dopri5), ``check_rows`` (rows of the checked
batch that the reference integrates: all of them where the method's step
control couples the rows, as dopri5's batch-wide error norm does),
``trace_evaluations``, ``limits``.

Each batch's noise and labels (uniform over the classes) are drawn on the
card from the run's seed and the batch's index. The batch in flight at the
deadline completes and counts. After the window, one batch drawn from the
seed is integrated again by the plain reference, and its images (and for an
adaptive method its NFE) are compared.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict

import torch

from cfmbench.harness import Check, derive_seed, strict_f32
from cfmbench.program import build_model
from cfmbench.reference import ode
from cfmbench.reference.unet import RefUNet
from cfmbench.weights import make_weights


def batch_inputs(run, b: int):
    """x0 (n, H, W, C) and labels (or None) of batch ``b``."""
    arch, n = run.cell.config["model"], run.cell.traffic["batch"]
    g = torch.Generator(device=run.device).manual_seed(derive_seed(run.seed, 4, b))
    x0 = torch.randn((n,) + tuple(arch["dim"]), generator=g, device=run.device)
    y = (torch.randint(0, arch["num_classes"], (n,), generator=g, device=run.device)
         if arch.get("class_cond") else None)
    return x0, y


class _Counted(torch.nn.Module):
    """The program's model, passed through, with a count of its calls so
    that a traced run traces a few evaluations inside a batch."""

    def __init__(self, model, on_call):
        super().__init__()
        self.model, self.on_call = model, on_call

    def forward(self, *args, **kw):
        self.on_call()
        return self.model(*args, **kw)


def drive(run) -> Dict:
    from cfm_tpu_torch import generate as program

    traffic, arch = run.cell.traffic, run.cell.config["model"]
    n, method = traffic["batch"], traffic["method"]
    model = build_model(run)
    run.apply_fault(model)
    run.mark("model")
    kw = dict(x_shape=tuple(arch["dim"]), method=method, n_steps=traffic.get("n_steps", 100),
              rtol=traffic.get("rtol", 1e-5), atol=traffic.get("atol", 1e-5))

    def batch(b: int, net=model, **over):
        x0, y = batch_inputs(run, b)
        return program.generate(net, n, x0=x0, y=y, device=run.device, **dict(kw, **over))

    # Warm-up: every shape of a batch, two evaluations.
    batch(0, method="euler", n_steps=2)
    run.sync()
    setup_peak = run.peak_bytes()
    if run.cuda:
        torch.cuda.reset_peak_memory_stats()
    tracer = run.tracer(model, traffic["trace_evaluations"])
    calls, open_step = [0], []

    def on_call():
        if open_step:
            open_step.pop().__exit__(None, None, None)
        tracer.advance(calls[0])
        open_step.append(tracer.step(calls[0]))
        open_step[-1].__enter__()
        calls[0] += 1

    net = _Counted(model, on_call) if tracer is not None else model
    images, nfes, failed = [], [], 0
    window_start = run.window_start()
    deadline = window_start + run.seconds
    b = 0
    while time.perf_counter() < deadline or b == 0:
        try:
            out = batch(b + 1, net=net if b == 0 else model)
        except RuntimeError:
            failed += n
            images.append(None)
            nfes.append(0)
        else:
            images.append(out.images)
            nfes.append(out.nfe)
        b += 1
        if open_step:
            open_step.pop().__exit__(None, None, None)
    if tracer is not None:
        tracer.finish(calls[0])
    run.sync()
    window_s = time.perf_counter() - window_start
    peak = max(setup_peak, run.peak_bytes())
    done = n * b - failed
    out = {"attempted": n * b, "failed": failed, "peak_bytes": peak,
           "window_peak_bytes": run.peak_bytes(),
           "e2e": {"gen_images_per_s": done / window_s},
           "trace": tracer.reduce() if tracer is not None else None,
           "images_per_s": done / window_s,
           "nfe_per_batch": sum(nfes) / len(nfes)}
    pick = derive_seed(run.seed, 5) % b
    kept, kept_nfe = images[pick], nfes[pick]
    del model, net, images
    gc.collect()
    if run.cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["checks"] = check(run, pick + 1, kept, kept_nfe)
    print(f"reference: {time.perf_counter() - t0:.2f} s", file=sys.stderr)
    return out


def check_rows(run) -> torch.Tensor:
    """The rows of a batch the reference integrates: all of them where the
    method's step control couples the rows (dopri5's batch-wide error norm),
    else ``check_rows`` drawn from the seed."""
    traffic = run.cell.traffic
    n, rows = traffic["batch"], traffic.get("check_rows", traffic["batch"])
    if traffic["method"] == "dopri5" and rows != n:
        raise ValueError("dopri5's error norm couples the rows: check the whole batch")
    g = torch.Generator(device=run.device).manual_seed(derive_seed(run.seed, 6))
    return torch.randperm(n, generator=g, device=run.device)[:rows].sort().values


def reference_images(run, b: int, rows: torch.Tensor, quant=None):
    """The plain reference's uint8 images of batch ``b``'s ``rows``, and its
    NFE (``quant``: the control)."""
    traffic, arch = run.cell.traffic, run.cell.config["model"]
    x0, y = batch_inputs(run, b)
    ref = RefUNet(arch, quant).to(run.device)
    ref.load_state_dict(make_weights(arch, run.cell.config["weights_seed"], run.device))
    x0 = x0[rows]
    y = None if y is None else y[rows]

    def field(t: float, x: torch.Tensor) -> torch.Tensor:
        return ref(torch.full((x.shape[0],), t, device=x.device), x, y)

    with torch.no_grad(), strict_f32():
        if traffic["method"] == "dopri5":
            final, nfe = ode.dopri5(field, x0, traffic["rtol"], traffic["atol"])
        else:
            final, nfe = ode.euler(field, x0, traffic["n_steps"])
    return ode.quantize(final), nfe


def gaps(images, nfe: int, want, want_nfe: int) -> Dict[str, float]:
    """``image_rms_levels``: the largest RMS difference of an image, in uint8
    levels; ``nfe_gap``: |NFE - NFE_ref| / NFE_ref."""
    per_image = torch.sqrt(torch.mean(torch.square(images.float() - want.float()),
                                      dim=(1, 2, 3)))
    return {"image_rms_levels": float(per_image.max()),
            "nfe_gap": abs(nfe - want_nfe) / want_nfe}


def check(run, b: int, images, nfe: int):
    """The program's images of batch ``b`` (and its NFE) against the
    reference's."""
    limits = run.cell.traffic["limits"]
    if images is None:
        return [Check(name, float("inf"), limit) for name, limit in limits.items()]
    rows = check_rows(run)
    want, want_nfe = reference_images(run, b, rows)
    found = gaps(images[rows], nfe, want, want_nfe)
    return [Check(name, found[name], limit) for name, limit in limits.items()]
