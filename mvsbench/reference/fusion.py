"""The eval's stage B in plain PyTorch, float64: the photometric and
geometric consistency filter and the fused point cloud, as the public
MVSNet evaluation defines them (``reproject_with_depth``,
``check_geometric_consistency``, ``filter_depth``).

A reference pixel (integer corners) is projected at its depth into each
source view, the source depth is sampled there bilinearly with a zero
border, and the point is projected back; the pixel is consistent with that
source when it returns within ``condmask_pixel`` pixels and its depth within
``condmask_depth`` of the reference's (relative). The photo mask is
confidence > ``photomask``, the geo mask at least ``geomask`` consistent
sources, the final mask both. The fused depth is the mean of the reference
depth and the consistent reprojections; it is back-projected at the pixel
centres and world x and y are scaled by ``xy_scale``. Departure, also the
port's: the bilinear weights are exact, not cv2's 1/32 steps.
"""

from __future__ import annotations

import numpy as np
import torch


def _sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img [H, W] at (x, y) [H, W]; taps outside read 0."""
    H, W = img.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    out = torch.zeros_like(x)
    for dx in (0, 1):
        for dy in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            wgt = (1 - (x - xi).abs()) * (1 - (y - yi).abs())
            inside = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            xi = torch.nan_to_num(xi, nan=0.0).clamp(0, W - 1).long()
            yi = torch.nan_to_num(yi, nan=0.0).clamp(0, H - 1).long()
            out = out + torch.where(inside, wgt * img[yi, xi], torch.zeros_like(x))
    return out


def reproject(depth_ref, K_ref, E_ref, depth_src, K_src, E_src):
    """-> (reprojected depth, x, y of the round trip), each [H, W]."""
    H, W = depth_ref.shape
    y, x = torch.meshgrid(torch.arange(H, dtype=depth_ref.dtype, device=depth_ref.device),
                          torch.arange(W, dtype=depth_ref.dtype, device=depth_ref.device), indexing="ij")
    pix = torch.stack([x.reshape(-1), y.reshape(-1), torch.ones(H * W, dtype=x.dtype, device=x.device)])
    xyz_ref = torch.linalg.inv(K_ref) @ (pix * depth_ref.reshape(-1))
    xyz_src = (E_src @ torch.linalg.inv(E_ref) @ torch.cat([xyz_ref, torch.ones_like(xyz_ref[:1])]))[:3]
    k_src = K_src @ xyz_src
    x_src, y_src = (k_src[0] / k_src[2]).reshape(H, W), (k_src[1] / k_src[2]).reshape(H, W)
    sampled = _sample(depth_src, x_src, y_src).reshape(-1)
    xyz_src2 = torch.linalg.inv(K_src) @ (torch.stack([x_src.reshape(-1), y_src.reshape(-1), pix[2]]) * sampled)
    xyz_back = (E_ref @ torch.linalg.inv(E_src) @ torch.cat([xyz_src2, torch.ones_like(xyz_src2[:1])]))[:3]
    k_back = K_ref @ xyz_back
    return (xyz_back[2].reshape(H, W), (k_back[0] / k_back[2]).reshape(H, W),
            (k_back[1] / k_back[2]).reshape(H, W))


def filter_view(depths: dict, confs: dict, Ks: dict, Es: dict, ref: int, srcs: list[int], *, photomask: float,
                geomask: int, condmask_pixel: float, condmask_depth: float, device) -> dict:
    """One reference view against its sources (views keyed by id; numpy
    maps and cameras) -> photo, geo and final masks (bool) and the fused
    depth, numpy."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=device)

    d_ref = t(depths[ref])
    H, W = d_ref.shape
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=device),
                          torch.arange(W, dtype=torch.float64, device=device), indexing="ij")
    geo_sum = torch.zeros((H, W), dtype=torch.int64, device=device)
    depth_sum = torch.zeros_like(d_ref)
    for s in srcs:
        d_back, x_back, y_back = reproject(d_ref, t(Ks[ref]), t(Es[ref]), t(depths[s]), t(Ks[s]), t(Es[s]))
        dist = torch.sqrt((x_back - x) ** 2 + (y_back - y) ** 2)
        ok = (dist < condmask_pixel) & ((d_back - d_ref).abs() / d_ref < condmask_depth)
        geo_sum += ok.long()
        depth_sum += torch.where(ok, d_back, torch.zeros_like(d_back))
    photo = t(confs[ref]) > photomask
    geo = geo_sum >= geomask
    fused = (depth_sum + d_ref) / (geo_sum + 1)
    return {"photo": photo.cpu().numpy(), "geo": geo.cpu().numpy(), "final": (photo & geo).cpu().numpy(),
            "fused": fused.cpu().numpy()}


def back_project(depth: np.ndarray, K: np.ndarray, E: np.ndarray, xy_scale: float, device) -> np.ndarray:
    """World points [H*W, 3] of a depth map at the pixel centres."""
    H, W = depth.shape
    d = torch.as_tensor(depth, dtype=torch.float64, device=device).reshape(-1)
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=device) + 0.5,
                          torch.arange(W, dtype=torch.float64, device=device) + 0.5, indexing="ij")
    pix = torch.stack([x.reshape(-1), y.reshape(-1), torch.ones_like(d)])
    Kt = torch.as_tensor(K, dtype=torch.float64, device=device)
    Et = torch.as_tensor(E, dtype=torch.float64, device=device)
    cam = torch.linalg.inv(Kt) @ pix * d
    world = (torch.linalg.inv(Et[:3, :3]) @ (cam - Et[:3, 3:4])).T
    world[:, :2] *= xy_scale
    return world.cpu().numpy()
