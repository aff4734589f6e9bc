"""Models (counterpart of ``cfm_tpu/models``): the 2-D tutorial's MLP and the
guided-diffusion UNet family."""

from cfm_tpu_torch.models.mlp import MLP
from cfm_tpu_torch.models.unet import (AttentionPool2d, EncoderUNetModel, SuperResModel, UNetModel,
                                       UNetModelWrapper)

__all__ = ["MLP", "AttentionPool2d", "EncoderUNetModel", "SuperResModel", "UNetModel",
           "UNetModelWrapper"]
