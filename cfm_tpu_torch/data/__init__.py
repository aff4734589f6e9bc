"""Data pipelines (counterpart of ``cfm_tpu/data``): the 2-D toy generators,
the image sets and the trajectory data (``data.trajectory``)."""

from cfm_tpu_torch.data.toy import (blobs, checkerboard, circles, eight_gaussians,
                                    eight_normal_sample, gaussian_mixture, moons, pinwheel,
                                    sample_8gaussians, sample_moons, scurve, spirals, swissroll,
                                    two_dim_data)

__all__ = ["blobs", "checkerboard", "circles", "eight_gaussians", "eight_normal_sample",
           "gaussian_mixture", "moons", "pinwheel", "sample_8gaussians", "sample_moons", "scurve",
           "spirals", "swissroll", "two_dim_data"]
