from .blocks import ConvBnReLU, ConvBnReLU3D, ConvTransposeBnReLU3D
from .cost_reg_net import CostRegNet
from .feature_net import FeatureNet
from .mvsnet import MVSNet, random_init_

__all__ = [
    "ConvBnReLU",
    "ConvBnReLU3D",
    "ConvTransposeBnReLU3D",
    "CostRegNet",
    "FeatureNet",
    "MVSNet",
    "random_init_",
]
