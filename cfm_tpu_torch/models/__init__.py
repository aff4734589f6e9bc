"""Models (counterpart of ``cfm_tpu/models``): the MLP family, the CNF
drift-net zoo of ``diffeq``, the guided-diffusion UNet family and the GRN
models of ``grn``."""

from cfm_tpu_torch.models import diffeq
from cfm_tpu_torch.models.diffeq import (AutoencoderDiffEqNet, BasicResBlock, ConvODEnet,
                                         HyperConv2d, ODEnet, ResNetDiffEq, SqueezeLayer)
from cfm_tpu_torch.models.mlp import (ICNN, MLP, GradModel, SimpleDenseNet,
                                      TimeInvariantVelocityNet, VelocityNet)
from cfm_tpu_torch.models.unet import (AttentionPool2d, EncoderUNetModel, SuperResModel, UNetModel,
                                       UNetModelWrapper)

__all__ = ["MLP", "VelocityNet", "TimeInvariantVelocityNet", "SimpleDenseNet", "GradModel",
           "ICNN", "ODEnet", "ConvODEnet", "HyperConv2d", "BasicResBlock", "ResNetDiffEq",
           "SqueezeLayer", "AutoencoderDiffEqNet", "diffeq", "AttentionPool2d",
           "EncoderUNetModel", "SuperResModel", "UNetModel", "UNetModelWrapper"]
