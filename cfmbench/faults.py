"""Faults planted in the measured path, for the tests that show the check
catches them: the program's functions are replaced in this process only.

- ``frozen``: a step returns its state unchanged (no optimizer or EMA
  update; in generation, an integration that returns its start);
- ``half_batch``: half of the batch is left out and the mean taken over the
  rest (the training path's pairs are cut to their first half);
- ``no_exchange``: the gradients' all-reduce between ranks is left out;
- ``altered``: the answers are altered where they are produced (every
  generated image shifted by 3 levels, so that the sampled rows hold some);
- ``fails_once``: one batch of the window fails (its integration ends
  non-finite, which the program raises on); the others are sound;
- ``forbidden_on_rank1``: rank 1 alone holds a module named ``cfm_tpu``
  (the import check must see a rank's modules, not only rank 0's).
"""

from __future__ import annotations


def apply(name: str, model, rank: int = 0) -> None:
    import cfm_tpu_torch.generate as generate
    import cfm_tpu_torch.train as train
    from cfm_tpu_torch.integrate import ODESolution
    from cfm_tpu_torch.paths import ExactOptimalTransportConditionalFlowMatcher as OT

    if name == "frozen":
        def apply_nothing(self, params, grads, state):
            import torch
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))

        train.Optimizer.apply = apply_nothing
        train.ema_update = lambda *a, **k: None
        generate.odeint = lambda f, x0, ts, **kw: ODESolution(
            x0[None].expand(2, *x0.shape), 0)
    elif name == "half_batch":
        original = OT.guided_sample_location_and_conditional_flow

        def half(self, *args, **kw):
            out = original(self, *args, **kw)
            n = out[0].shape[0] // 2
            return tuple(v[:n] if getattr(v, "dim", lambda: 0)() > 0 else v for v in out)

        OT.guided_sample_location_and_conditional_flow = half
    elif name == "no_exchange":
        def local(tensors, group, scale):
            return [t * scale for t in tensors]

        train._all_reduce_flat = local
    elif name == "altered":
        import torch

        quantize = generate.quantize_to_uint8

        def altered(x):
            out = quantize(x)
            return torch.where(out < 128, out + 3, out - 3)

        generate.quantize_to_uint8 = altered
    elif name == "fails_once":
        odeint, calls = generate.odeint, [0]

        def once(f, x0, ts, **kw):
            sol = odeint(f, x0, ts, **kw)
            calls[0] += 1
            # Call 1 is the warm-up, call 2 the window's first batch.
            return sol._replace(ys=sol.ys * float("nan")) if calls[0] == 3 else sol

        generate.odeint = once
    elif name == "forbidden_on_rank1":
        import sys
        import types

        if rank == 1:
            sys.modules["cfm_tpu"] = types.ModuleType("cfm_tpu")
    else:
        raise ValueError(f"unknown fault {name!r}")
