"""Datasets and the host input pipeline of the port, numpy and Pillow only.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/data``: the same
registry (name -> ``MVSDataset`` class, the reference's
``find_dataset_def``), the same samples (``img_cache`` reads through the
decoded-image cache), ``Loader`` and ``BackgroundLoader``, and
``prefetch_to_device``, which stages batches in pinned memory and copies
them to the card a step ahead; and ``synthetic``, which writes analytic
scenes in the reference's dataset layouts."""

import importlib

from .pipeline import BackgroundLoader, Loader, PinnedStaging, pack_u8_imgs, prefetch_to_device

_DATASET_MODULES = {
    "dtu_yao": ".dtu_yao",
    "blender": ".blender",
    "dtu_yao_eval": ".dtu_yao_eval",
    "blender_eval": ".blender_eval",
    "dataloader_eval": ".dataloader_eval",
}


def find_dataset_def(dataset_name: str):
    """The ``MVSDataset`` class of a dataset name."""
    if dataset_name not in _DATASET_MODULES:
        raise KeyError(f"unknown dataset {dataset_name!r}; available: {sorted(_DATASET_MODULES)}")
    return importlib.import_module(_DATASET_MODULES[dataset_name], package=__name__).MVSDataset


__all__ = ["BackgroundLoader", "Loader", "PinnedStaging", "find_dataset_def", "pack_u8_imgs", "prefetch_to_device"]
