"""The port's models and their blocks. ``find_model_def(name)`` is the
model registry: ``mvsnet`` (the training CLI's ``--model``, the reference's
``--model mvsnet``), ``casmvsnet`` (CasMVSNet's cascade) and ``rmvsnet``
(R-MVSNet's recurrent regulariser over depth), the last two inference only,
each called as ``model(imgs, proj_matrices, depth_values)`` and served by
``infer.py::make_infer_step``. ``require_model(name, path)`` is the CLIs'
lookup: it refuses a model without that path (training or the eval CLIs),
naming the ROADMAP.md item that plans it."""

from .blocks import BasicBlock, ConvBnReLU, ConvBnReLU3D, ConvGRUCell, ConvTransposeBnReLU3D, Hourglass3d
from .cas_mvsnet import CasMVSNet
from .cost_reg_net import CostRegNet
from .feature_net import FeatureNet
from .fpn_feature_net import FPNFeatureNet
from .mvsnet import MVSNet, mvsnet_loss, random_init_
from .refine_net import RefineNet
from .rmvsnet import RMVSNet

_MODELS = {"mvsnet": MVSNet, "casmvsnet": CasMVSNet, "rmvsnet": RMVSNet}


def find_model_def(name: str):
    """The model class registered as ``name``; a KeyError lists the names."""
    try:
        return _MODELS[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_MODELS)}")


def require_model(name: str, path: str):
    """``find_model_def(name)``, where that model has ``path`` ("train" or
    "eval"); else NotImplementedError naming the ROADMAP.md item that plans
    it (the class's ``missing_paths``)."""
    model_def = find_model_def(name)
    item = getattr(model_def, "missing_paths", {}).get(path)
    if item is not None:
        what = "training" if path == "train" else path
        raise NotImplementedError(f"--model {name} has no {what} path yet ({item})")
    return model_def


__all__ = [
    "BasicBlock",
    "CasMVSNet",
    "ConvBnReLU",
    "ConvBnReLU3D",
    "ConvGRUCell",
    "ConvTransposeBnReLU3D",
    "CostRegNet",
    "FPNFeatureNet",
    "FeatureNet",
    "Hourglass3d",
    "MVSNet",
    "RMVSNet",
    "RefineNet",
    "find_model_def",
    "mvsnet_loss",
    "random_init_",
    "require_model",
]
