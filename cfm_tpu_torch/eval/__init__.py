"""Evaluation (counterpart of ``cfm_tpu/eval``): the FID protocol pieces."""
