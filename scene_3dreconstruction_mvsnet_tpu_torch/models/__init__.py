"""The port's models and their blocks. ``find_model_def(name)`` is the
model registry: ``mvsnet`` (the training CLI's ``--model``, the reference's
``--model mvsnet``) and ``casmvsnet`` (inference only), each called as
``model(imgs, proj_matrices, depth_values)``."""

from .blocks import BasicBlock, ConvBnReLU, ConvBnReLU3D, ConvTransposeBnReLU3D, Hourglass3d
from .cas_mvsnet import CasMVSNet
from .cost_reg_net import CostRegNet
from .feature_net import FeatureNet
from .fpn_feature_net import FPNFeatureNet
from .mvsnet import MVSNet, mvsnet_loss, random_init_
from .refine_net import RefineNet

_MODELS = {"mvsnet": MVSNet, "casmvsnet": CasMVSNet}


def find_model_def(name: str):
    """The model class registered as ``name``; a KeyError lists the names."""
    try:
        return _MODELS[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_MODELS)}")


__all__ = [
    "BasicBlock",
    "CasMVSNet",
    "ConvBnReLU",
    "ConvBnReLU3D",
    "ConvTransposeBnReLU3D",
    "CostRegNet",
    "FPNFeatureNet",
    "FeatureNet",
    "Hourglass3d",
    "MVSNet",
    "RefineNet",
    "find_model_def",
    "mvsnet_loss",
    "random_init_",
]
