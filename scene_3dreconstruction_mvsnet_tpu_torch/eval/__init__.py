"""Two-stage evaluation of the port: stage A writes a depth map per
reference view (``depth_gen.save_depth``), stage B filters them for
photometric and geometric consistency and fuses them into a point cloud
(``fusion.filter_depth``). Counterpart of
``scene_3dreconstruction_mvsnet_tpu/eval``; the file codecs and datasets are
the port's ``io`` and ``data`` packages."""

from .depth_gen import save_depth
from .filtering import (
    check_geometric_consistency,
    fuse_reference_view,
    fuse_scan,
    geometric_filter_stack,
    reproject_with_depth,
)
from .fusion import filter_depth
from .scene_kit import (
    BBox,
    camera_poses,
    get_frame_bbox,
    postprocess_cloud,
    remove_statistical_outliers,
    voxel_down_sample,
)

__all__ = [
    "BBox",
    "camera_poses",
    "check_geometric_consistency",
    "filter_depth",
    "fuse_reference_view",
    "fuse_scan",
    "geometric_filter_stack",
    "get_frame_bbox",
    "postprocess_cloud",
    "remove_statistical_outliers",
    "reproject_with_depth",
    "save_depth",
    "voxel_down_sample",
]
