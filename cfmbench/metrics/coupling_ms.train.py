"""Device ms a traced step of the auction kernels (kernels/auction.json)."""

from cfmbench.readers import per_step_ms

read = per_step_ms("auction")
