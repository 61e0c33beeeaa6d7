"""Level-set surface point sampling from camera depth maps.

Port of ``sugar_tpu/meshing/levelset.py``, the recast of
SuGaR.compute_level_surface_points_from_camera_fast (sugar_model.py:
1848-2083) with the ``use_gaussian_depth`` design: the depth map comes from
the splat rasterizer (view z as color, bg -1) and each pixel's Gaussian is
found by KNN of the backprojected point. Invalid pixels are masked, not
dropped.

Per camera:
1. render depth (K1 alone, no gradient); pixels with no splat coverage get
   depth = 1.05 * max;
2. backproject every pixel to world space;
3. 16-NN Gaussian lookup per point; the nearest defines the ray sigma
   (std of that Gaussian along the view ray);
4. sample 21 points in +-3 sigma along the camera ray, evaluate the density
   field (density_factor 1, clamped at 1);
5. find the first crossing of the surface level walking front-to-back and
   linearly interpolate the intersection; normals = -grad density.

Everything runs under ``torch.no_grad()`` on the params' device. The JAX
function streams the field query in ``lax.map`` chunks of 2^16 samples;
here the caller's loop takes ``CHUNK`` queries at a time (every reduction
is over the K neighbors, so chunking changes no value). The depth render
keeps the JAX function's fixed caps and reads no overflow counter, as
the JAX function does; its counters are returned beside the points.
"""

from __future__ import annotations

import numpy as np
import torch

from sugar_tpu_torch.core.cameras import Camera
from sugar_tpu_torch.core.quaternions import normalize as quat_normalize
from sugar_tpu_torch.core.quaternions import quaternion_apply, quaternion_invert
from sugar_tpu_torch.fields import density as df
from sugar_tpu_torch.fields.knn import knn
from sugar_tpu_torch.models.gaussians import GaussianModel, GaussianParams
from sugar_tpu_torch.raster import adaptive
from sugar_tpu_torch.raster.common import clip
from sugar_tpu_torch.trainers.coarse import render_params_with_colors

# Queries per field-query / gradient chunk (x 16 neighbors: a (9, 4M)
# float32 gather, 151 MB).
CHUNK = 2**18


def ray_offsets(range_size: float, n: int, device=None) -> torch.Tensor:
    """``jnp.linspace(-range_size, range_size, n)`` in float32, bit for bit
    as XLA compiles it: i * (1/div) for the step, the stop term
    reassociated to i * (stop * (1/div)), the endpoint appended."""
    f32 = dict(dtype=torch.float32, device=device)
    div = n - 1
    i = torch.arange(div, **f32)
    recip = torch.tensor(1.0, **f32) / div
    lo, hi = torch.tensor(-range_size, **f32), torch.tensor(range_size, **f32)
    return torch.cat([lo * (1.0 - i * recip) + i * (hi * recip), hi[None]])


@torch.no_grad()
def level_surface_points_one_camera(
    params: GaussianParams,
    alive: torch.Tensor,
    camera: Camera,
    surface_level: float = 0.3,
    n_points_in_range: int = 21,
    range_size: float = 3.0,
    knn_to_track: int = 16,
    dup_capacity: int = 2**22,
    k_max: int = 1024,
) -> dict:
    """Returns dict(points (P,3), normals (P,3), gaussian_idx (P,), valid
    (P,) bool, depth (H,W)) with P = H*W (masked), plus the depth render's
    overflow counters (``raster.adaptive.overflow_counters``), on the params'
    device."""
    dev = params.xyz.device
    h, w = camera.height, camera.width
    scales = torch.exp(params.log_scales)
    quats = quat_normalize(params.quaternions)
    gp = df.GaussianFieldParams(centers=params.xyz, scales=scales, quaternions=quats,
                                opacities=torch.sigmoid(params.opacity_logit))

    # 1. depth map
    zs = params.xyz @ camera.world_view[2, :3] + camera.world_view[2, 3]
    depth_out = render_params_with_colors(
        params, alive, camera, zs[:, None].expand(-1, 3),
        bg=torch.full((3,), -1.0, device=dev), dup_capacity=dup_capacity, k_max=k_max,
    )
    depth = depth_out["image"][..., 0]  # (H, W)
    no_depth = depth < 0.0
    depth = torch.where(no_depth, depth.amax() * 1.05, depth)

    # 2. backproject pixels (inverse of ndc2Pix + projection_matrix).
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    ndc_x = (2.0 * xs.to(torch.float32) + 1.0) / w - 1.0
    ndc_y = (2.0 * ys.to(torch.float32) + 1.0) / h - 1.0
    x_cam = ndc_x * camera.tan_half_fov_x * depth
    y_cam = ndc_y * camera.tan_half_fov_y * depth
    cam_pts = torch.stack([x_cam, y_cam, depth], dim=-1).reshape(-1, 3)
    world_pts = cam_pts @ camera.world_view[:3, :3] + camera.cam_center  # (P, 3)

    # 3. nearest gaussians per point
    _, cg_idx = knn(world_pts, params.xyz, k=knn_to_track, ref_mask=alive)
    g0 = cg_idx[:, 0]

    cam_dir_g = camera.cam_center[None] - params.xyz
    cam_dir_g = cam_dir_g / torch.clamp_min(torch.linalg.norm(cam_dir_g, dim=-1, keepdim=True),
                                            1e-12)
    g_std = torch.linalg.norm(scales * quaternion_apply(quaternion_invert(quats), cam_dir_g),
                              dim=-1)
    pt_std = g_std[g0]  # (P,)

    # 4. ray samples and their densities, CHUNK samples at a time
    t_range = ray_offsets(range_size, n_points_in_range, dev)[None, :] * pt_std[:, None]
    ray_dir = world_pts - camera.cam_center
    ray_dir = ray_dir / torch.clamp_min(torch.linalg.norm(ray_dir, dim=-1, keepdim=True), 1e-12)
    pix = max(1, CHUNK // n_points_in_range)
    dens = torch.empty_like(t_range)
    for p0 in range(0, world_pts.shape[0], pix):
        sl = slice(p0, p0 + pix)
        samples = world_pts[sl, None, :] + t_range[sl, :, None] * ray_dir[sl, None, :]
        nbrs = cg_idx[sl].repeat_interleave(n_points_in_range, dim=0)
        d = df.field_values(samples.reshape(-1, 3), nbrs, gp, density_factor=1.0,
                            return_sdf=False)["density"]
        dens[sl] = torch.clamp_max(d, 1.0).reshape(-1, n_points_in_range)

    # 5. first crossing (sugar_model.py:2016-2052)
    above = dens > surface_level
    first_above = torch.argmax(above.to(torch.uint8), dim=-1)  # first True (0 if none)
    under0 = dens[:, 0] < surface_level
    valid = under0 & (first_above > 0) & ~no_depth.reshape(-1)

    fa = torch.clamp_min(first_above, 1)[:, None]
    d_hi = torch.gather(dens, 1, fa)[:, 0]
    d_lo = torch.gather(dens, 1, fa - 1)[:, 0]
    t_hi = torch.gather(t_range, 1, fa)[:, 0]
    t_lo = torch.gather(t_range, 1, fa - 1)[:, 0]
    gap = d_hi - d_lo
    t_int = (surface_level - d_lo) / torch.where(gap.abs() > 1e-12, gap, 1.0) * (t_hi - t_lo) + t_lo
    pts_int = world_pts + t_int[:, None] * ray_dir

    # 6. normals = -grad density at the intersection
    grad = _density_grad(pts_int, cg_idx, gp)
    normals = -grad / torch.clamp_min(torch.linalg.norm(grad, dim=-1, keepdim=True), 1e-12)

    out = dict(points=pts_int, normals=normals, gaussian_idx=g0, valid=valid, depth=depth)
    out.update(adaptive.overflow_counters(depth_out))
    return out


@torch.no_grad()
def _density_grad(x: torch.Tensor, neighbor_idx: torch.Tensor, gp: df.GaussianFieldParams,
                  chunk: int = CHUNK) -> torch.Tensor:
    """Analytic gradient of the density at x over its neighbors,
    sum_k o_k exp(-q_k/2) Sigma_k^-1 (x - mu_k) (the negated gradient), with
    the JAX function's component-major (rows, C*K) gathers."""
    out = []
    for c0 in range(0, x.shape[0], chunk):
        idx = neighbor_idx[c0:c0 + chunk]
        c_n, k_n = idx.shape
        mm, warped, flat = df.warp_neighbors(x[c0:c0 + chunk], idx, gp)
        quad = clip(warped[0] * warped[0] + warped[1] * warped[1] + warped[2] * warped[2],
                    0.0, 1e8)
        wt = gp.opacities[flat] * torch.exp(-0.5 * quad)  # (C*K,)
        out.append(torch.stack(
            [(wt * (mm[3 * i] * warped[0] + mm[3 * i + 1] * warped[1]
                    + mm[3 * i + 2] * warped[2])).reshape(c_n, k_n).sum(dim=-1)
             for i in range(3)], dim=-1))  # (C, 3)
    if not out:
        return x.new_zeros((0, 3))
    return torch.cat(out)


def collect_surface_points(
    model: GaussianModel,
    cameras: list[Camera],
    surface_level: float = 0.3,
    total_points: int = 10_000_000,
    rng: np.random.Generator | None = None,
    dup_capacity: int = 2**22,
    k_max: int = 1024,
    colors_per_gaussian: np.ndarray | None = None,
) -> dict:
    """Accumulate the level-set point cloud over all training cameras
    (sugar_extractors/coarse_mesh.py:230-327): up to total/n_cams valid
    points per camera, with normals, colors and source gaussian ids, as
    numpy arrays, and ``overflow``: each camera's depth-render counters
    (host ints). The subsample draws from ``rng`` in the JAX function's
    order, so the cloud is the JAX package's."""
    rng = rng or np.random.default_rng(0)
    per_cam = total_points // max(len(cameras), 1)
    pts, nrm, gid, cols, ovf = [], [], [], [], []
    for cam in cameras:
        out = level_surface_points_one_camera(
            model.params, model.alive, cam, surface_level=surface_level,
            dup_capacity=dup_capacity, k_max=k_max,
        )
        idx = np.nonzero(out["valid"].cpu().numpy())[0]
        if len(idx) > per_cam:
            idx = rng.choice(idx, size=per_cam, replace=False)
        sel = torch.as_tensor(idx, device=out["points"].device)
        pts.append(out["points"][sel].cpu().numpy())
        nrm.append(out["normals"][sel].cpu().numpy())
        g = out["gaussian_idx"][sel].cpu().numpy()
        gid.append(g)
        if colors_per_gaussian is not None:
            cols.append(colors_per_gaussian[g])
        ovf.append(adaptive.read_overflow(out))
    return dict(
        points=np.concatenate(pts) if pts else np.zeros((0, 3), np.float32),
        normals=np.concatenate(nrm) if nrm else np.zeros((0, 3), np.float32),
        gaussian_idx=np.concatenate(gid) if gid else np.zeros((0,), np.int64),
        colors=np.concatenate(cols) if cols else None,
        overflow=ovf,
    )
