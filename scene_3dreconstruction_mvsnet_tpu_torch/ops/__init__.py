from .plane_sweep import cost_volume_variance
from .regression import depth_regression, photometric_confidence, regress_depth_and_confidence
from .sampling import bilinear_sample_2d, grid_sample_2d, warp_src_feature, warp_src_feature_grad

__all__ = [
    "bilinear_sample_2d",
    "cost_volume_variance",
    "depth_regression",
    "grid_sample_2d",
    "photometric_confidence",
    "regress_depth_and_confidence",
    "warp_src_feature",
    "warp_src_feature_grad",
]
