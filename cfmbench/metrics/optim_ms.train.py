"""Device ms a traced step of the optimizer's and the EMA's multi-tensor
kernels (kernels/optimizer.json)."""

from cfmbench.readers import per_step_ms

read = per_step_ms("optimizer")
