"""The GroupNorm calls outside attention blocks: their bound over the device
time attributed to them (kernels/groupnorm.json), forward, in %."""

from cfmbench.readers import roofline

read = roofline("groupnorm", backward=False)
