"""Data pipelines (counterpart of ``cfm_tpu/data``): the image sets."""
