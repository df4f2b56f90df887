from .transforms import (
    compose_projection_matrix,
    depth_to_world_points,
    invert_4x4,
    invert_rigid,
    matmul_f32,
    pixel_grid,
    pixel_grid_centered,
    plane_sweep_coords,
    project_points,
)

__all__ = [
    "compose_projection_matrix",
    "depth_to_world_points",
    "invert_4x4",
    "invert_rigid",
    "matmul_f32",
    "pixel_grid",
    "pixel_grid_centered",
    "plane_sweep_coords",
    "project_points",
]
