"""The attention blocks' bound over the device time attributed to them
(kernels/attention.json), forward, in %."""

from cfmbench.readers import roofline

read = roofline("attention", backward=False)
