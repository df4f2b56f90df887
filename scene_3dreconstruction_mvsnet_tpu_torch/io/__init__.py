"""Host-side file formats of the port, numpy and Pillow only: the PFM codec,
the MVS cam and pair files, images and masks (and the decoded-image caches), and binary PLY clouds.
Counterpart of ``scene_3dreconstruction_mvsnet_tpu/io``; each module writes
the same bytes as its counterpart there."""

from .cams import read_cam_file, read_camera_parameters, read_pair_file, write_cam, write_pair_file
from .images import (
    read_img,
    read_img_cached,
    read_mask,
    read_rescale_crop_img,
    read_rescale_crop_img_cached,
    resize_img,
    save_image_u8,
    save_mask,
)
from .pfm import read_pfm, save_pfm
from .ply import read_ply, write_ply

__all__ = [
    "read_cam_file",
    "read_camera_parameters",
    "read_img",
    "read_img_cached",
    "read_mask",
    "read_pair_file",
    "read_pfm",
    "read_ply",
    "read_rescale_crop_img",
    "read_rescale_crop_img_cached",
    "resize_img",
    "save_image_u8",
    "save_mask",
    "save_pfm",
    "write_cam",
    "write_pair_file",
    "write_ply",
]
