"""Device ms a traced step of the NCCL kernels (kernels/nccl.json), rank 0."""

from cfmbench.readers import per_step_ms

read = per_step_ms("nccl")
