"""Models (counterpart of ``cfm_tpu/models``): the guided-diffusion UNet."""

from cfm_tpu_torch.models.unet import UNetModel, UNetModelWrapper

__all__ = ["UNetModel", "UNetModelWrapper"]
