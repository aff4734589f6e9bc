"""The model's FLOP/s over the bf16 peak, in % (forward and backward; readers.mfu_pct)."""

from cfmbench.readers import mfu_train as read  # noqa: F401
