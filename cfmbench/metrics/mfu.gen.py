"""The model's FLOP/s over the bf16 peak, in % (forward; readers.mfu_pct)."""

from cfmbench.readers import mfu_gen as read  # noqa: F401
