"""Models (counterpart of ``cfm_tpu/models``): the guided-diffusion UNet family."""

from cfm_tpu_torch.models.unet import (AttentionPool2d, EncoderUNetModel, SuperResModel, UNetModel,
                                       UNetModelWrapper)

__all__ = ["AttentionPool2d", "EncoderUNetModel", "SuperResModel", "UNetModel", "UNetModelWrapper"]
