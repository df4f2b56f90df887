from .transforms import (
    compose_projection_matrix,
    invert_4x4,
    pixel_grid,
    plane_sweep_coords,
)

__all__ = [
    "compose_projection_matrix",
    "invert_4x4",
    "pixel_grid",
    "plane_sweep_coords",
]
