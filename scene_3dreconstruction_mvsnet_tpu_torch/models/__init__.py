"""The port's models and their blocks. ``find_model_def(name)`` is the
``--model`` registry of the training CLI (the reference's ``--model
mvsnet``)."""

from .blocks import BasicBlock, ConvBnReLU, ConvBnReLU3D, ConvTransposeBnReLU3D, Hourglass3d
from .cost_reg_net import CostRegNet
from .feature_net import FeatureNet
from .mvsnet import MVSNet, mvsnet_loss, random_init_
from .refine_net import RefineNet

_MODELS = {"mvsnet": MVSNet}


def find_model_def(name: str):
    """The model class registered as ``name``; a KeyError lists the names."""
    try:
        return _MODELS[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_MODELS)}")


__all__ = [
    "BasicBlock",
    "ConvBnReLU",
    "ConvBnReLU3D",
    "ConvTransposeBnReLU3D",
    "CostRegNet",
    "FeatureNet",
    "Hourglass3d",
    "MVSNet",
    "RefineNet",
    "find_model_def",
    "mvsnet_loss",
    "random_init_",
]
