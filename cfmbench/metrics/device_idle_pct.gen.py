"""1 - the union of the card's operations over the traced window, in %."""

from cfmbench.readers import device_idle_pct as read  # noqa: F401
