from .blocks import ConvBnReLU, ConvBnReLU3D, ConvTransposeBnReLU3D
from .cost_reg_net import CostRegNet
from .feature_net import FeatureNet
from .mvsnet import MVSNet, mvsnet_loss, random_init_
from .refine_net import RefineNet

__all__ = [
    "ConvBnReLU",
    "ConvBnReLU3D",
    "ConvTransposeBnReLU3D",
    "CostRegNet",
    "FeatureNet",
    "MVSNet",
    "RefineNet",
    "mvsnet_loss",
    "random_init_",
]
