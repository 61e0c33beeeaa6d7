"""SuGaR's refined hybrid model (configuration kind ``refined_mesh``):
Gaussians bound to the triangles of a mesh, one per face.

``build`` makes the lat-long mesh of the blob surface and the bound
parameters' trained-statistics draws on the device from the seed.
``Program`` binds the mesh through the port's ``refine/bound.
init_bound_params`` and drives ``refine.trainer.make_refine_step`` with
the loop's own host work; ``Server`` converts the bound model to free
Gaussians as ``export_refined_ply`` writes them and renders it through
``models.render.render_model``. ``Reference`` and ``reference_image``
follow both in plain PyTorch from the same inputs.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from benchmark import frozen, scenes
from benchmark.drivers import train as loop
from benchmark.reference import bound as rb
from benchmark.reference import losses as rl
from benchmark.reference import raster as rr
from benchmark.models.free_gaussians import program_camera

FIELDS = ("vertices", "log_scales", "complex_rot", "opacity_logit", "sh_dc", "sh_rest")
# refine.py: position rates 0.01 x the vanilla ones on the exponential
# schedule, scaled by 10 x bbox radius / sqrt(V); the others constant.
POS_LR = (0.00016 * 0.01, 0.0000016 * 0.01, 30_000)
LRS = dict(log_scales=0.005, complex_rot=0.001, opacity_logit=0.05, sh_dc=0.0025,
           sh_rest=0.0025 / 20.0)
NORMAL_FACTOR = 0.1
# Inputs the benchmark keeps on the host once the program has its own.
HOST_KEYS = ("vertices", "colors", "log_scale_factor", "complex_rot", "opacity_logit", "sh_rest")


def build(cfg: dict, seed: int, device, role: str = "train") -> dict:
    """The benchmark's inputs: the mesh, its face adjacency, the vertex
    colours, the per-face draws (in-plane log-scale factors, rotation,
    opacity logits, higher SH bands), the views (training or the orbit's,
    set by the driver), the targets for training, the extent."""
    verts, faces = scenes.latlong_mesh(cfg, device)
    f = faces.shape[0]
    k = (cfg["sh_degree"] + 1) ** 2
    g = scenes.generator(seed, 2, device)
    lo, hi = cfg["scale_factor"]
    lf = torch.log(frozen.uniform(g, lo, hi, (f, 2), device)).to(torch.float32)
    ang = frozen.uniform(g, 0.0, 2 * math.pi, (f,), device)
    cr = torch.stack([torch.cos(ang), torch.sin(ang)], -1).to(torch.float32)
    op = frozen.uniform(g, *cfg["opacity"], (f,), device)
    ol = torch.log(op / (1.0 - op)).to(torch.float32)
    sr = torch.randn((f, 3, k - 1), generator=g, device=device) * cfg["sh_rest_std"]
    views = scenes.spiral_views(cfg)
    ext = scenes.extent(views)
    vd = verts.to(torch.float64)
    bbox_radius = 0.5 * float(torch.linalg.norm(vd.max(0).values - vd.min(0).values))
    return dict(
        vertices=verts, faces=faces, pairs=scenes.face_pairs(faces),
        colors=frozen.blob_colors(verts.to(torch.float64)), log_scale_factor=lf,
        complex_rot=cr, opacity_logit=ol, sh_rest=sr, sh_degree=cfg["sh_degree"],
        views=[v.to(device) for v in views], extent=ext, thickness=ext / 1e6,
        spatial_lr_scale=10.0 * bbox_radius / math.sqrt(verts.shape[0]),
        targets=scenes.targets(cfg, views, device) if role == "train" else None,
    )


def _program_bound(inp: dict):
    """Bind the mesh through the port and set the benchmark's draws."""
    from sugar_tpu_torch.refine import bound as B

    dev = inp["vertices"].device
    params, bm = B.init_bound_params(
        inp["vertices"].cpu().numpy(), inp["faces"].cpu().numpy(), inp["colors"].cpu().numpy(),
        n_gaussians_per_triangle=1, extent=inp["extent"], sh_degree=inp["sh_degree"], device=dev)
    params = dataclasses.replace(
        params, log_scales=params.log_scales + inp["log_scale_factor"],
        complex_rot=inp["complex_rot"].clone(), opacity_logit=inp["opacity_logit"].clone(),
        sh_rest=inp["sh_rest"].clone())
    return params, bm


class Program:
    """The port's refinement state and its loop body (``refine/trainer.py``
    ``refined_training``) from ``start``."""

    def __init__(self, inp: dict, traffic: dict):
        from sugar_tpu_torch.raster import adaptive
        from sugar_tpu_torch.refine import trainer as T
        from sugar_tpu_torch.trainers.schedule import CameraSchedule

        self._T = T
        self._adaptive = adaptive
        self.cfg = T.RefineConfig(sh_degree=inp["sh_degree"])
        self.params, self.bm = _program_bound(inp)
        self.pairs = inp["pairs"]
        self.lrs = T.bound_lrs(self.cfg, inp["spatial_lr_scale"])
        self.adam = T.init_bound_adam(self.params)
        g = self.params.opacity_logit.shape[0]
        self.cap_state = adaptive.CapState(adaptive.RasterCaps(
            tile_cap=traffic["tile_cap"], dup_capacity=self.cfg.dup_capacity_mult * g, k_max=self.cfg.k_max))
        self.sched = CameraSchedule(loop.SCHEDULE_SEED, len(inp["views"]))
        self.cams = [program_camera(v) for v in inp["views"]]
        self.targets = inp["targets"]
        self.step_cache = {}
        self.prev_aux = None
        self.hot_until = traffic["start_iteration"] + loop.HOT_STEPS

    def _deg(self, it: int) -> int:
        return min(it // self.cfg.sh_warmup_every, self.cfg.sh_degree)

    @torch.no_grad()
    def settle_caps(self) -> None:
        bg = torch.zeros(3, device=self.pairs.device)
        caps = self.cap_state.caps
        for cam in self.cams:
            _, caps = self._adaptive.render_adaptive(
                self._T.render_bound, caps, self.params, self.bm, cam, self.cfg.sh_degree, bg)
        self.cap_state.caps = caps

    def step_fn(self, it: int):
        key = (self._deg(it), self.cap_state.key())
        if key not in self.step_cache:
            self.step_cache[key] = self._T.make_refine_step(
                self.cfg, self.bm, self.pairs, self.lrs, key[0], self.cap_state.caps)
        return self.step_cache[key]

    def warm_up(self, it: int) -> None:
        ci = self.sched.index(it)
        self.step_fn(it)(self.params, self.adam, self.cams[ci], self.targets[ci], it)

    def iterate(self, it: int) -> tuple[int, dict]:
        step = self.step_fn(it)
        ci = self.sched.index(it)
        self.params, self.adam, aux = step(self.params, self.adam, self.cams[ci],
                                           self.targets[ci], it)
        loop.lagged_check(self, it, aux)
        return ci, aux

    def leaves(self) -> dict:
        return {f: getattr(self.params, f) for f in FIELDS}

    def first_grad(self) -> dict:
        return {f: getattr(self.adam.mu, f) / (1.0 - self.cfg.beta1) for f in FIELDS}


def _bary_colors(inp: dict, dev) -> torch.Tensor:
    fc = inp["colors"].to(dev)[inp["faces"].to(dev)]
    third = torch.tensor(1.0 / 3.0, dtype=torch.float32, device=fc.device)
    return fc[:, 0] * third + fc[:, 1] * third + fc[:, 2] * third


def reference_params(inp: dict, dev) -> dict:
    """The bound parameters worked out from the inputs, on ``dev``."""
    v = inp["vertices"].to(dev)
    f = inp["faces"].to(dev)
    return dict(
        vertices=v.clone(),
        log_scales=rb.init_log_scales(v, f) + inp["log_scale_factor"].to(dev),
        complex_rot=inp["complex_rot"].to(dev, copy=True),
        opacity_logit=inp["opacity_logit"].to(dev, copy=True),
        sh_dc=(_bary_colors(inp, dev) - 0.5) / rr.SH_C0,
        sh_rest=inp["sh_rest"].to(dev, copy=True),
    )


def reference_screen(leaves: dict, inp: dict, view: rr.View, deg: int) -> rr.Screen:
    faces = inp["faces"].to(leaves["vertices"].device)
    centers, rot, scales = rb.gaussians(leaves["vertices"], faces, leaves["log_scales"],
                                        leaves["complex_rot"], inp["thickness"])
    sh = torch.cat([leaves["sh_dc"][:, :, None], leaves["sh_rest"]], -1)
    return rr.project(centers, rr.cov_from_rotation(rot, scales),
                      torch.sigmoid(leaves["opacity_logit"]), view, sh=sh, sh_degree=deg)


class Reference:
    """Refinement in plain PyTorch: bound Gaussians, render, RGB loss plus
    0.1 x normal consistency, backward, Adam. ``dtype`` and ``half`` as in
    ``free_gaussians.Reference``."""

    def __init__(self, inp: dict, dev, dtype=torch.float32, half: bool = False):
        self.inp = inp
        self.dev = dev
        self.params = reference_params(inp, dev)
        self.views = inp["views"]
        self.targets = inp["targets"]
        self.deg = inp["sh_degree"]
        self.dtype, self.half = dtype, half
        self.state = rl.adam_init(self.params)

    def step(self, it: int, vi: int, count: dict | None = None) -> tuple[float, dict]:
        view = self.views[vi].to(self.dev, self.dtype)
        leaves = {k: p.detach().to(self.dtype).requires_grad_(True) for k, p in self.params.items()}
        sc = reference_screen(leaves, self.inp, view, self.deg)
        if count is not None:
            count["visible"] = int(sc.visible.sum())
        bg = torch.zeros(3, dtype=self.dtype, device=self.dev)
        img, groups = rr.render(sc, view, bg, count)
        img = img.detach().requires_grad_(True)
        gt = self.targets[vi].to(self.dtype)
        rows = img.shape[0] // 2 if self.half else img.shape[0]
        rgb = rl.rgb_loss(img[:rows], gt[:rows])
        rgb.backward()
        rr.backward(sc, view, bg, groups, img.grad)
        nc = rb.normal_consistency(leaves["vertices"], self.inp["faces"].to(self.dev),
                                   self.inp["pairs"].to(self.dev))
        (NORMAL_FACTOR * nc).backward()
        loss = float(rgb.detach()) + NORMAL_FACTOR * float(nc.detach())
        grads = {k: (leaves[k].grad if leaves[k].grad is not None
                     else torch.zeros_like(leaves[k])).to(torch.float32) for k in FIELDS}
        s = self.inp["spatial_lr_scale"]
        lrs = dict(LRS, vertices=rl.expon_lr(POS_LR[0] * s, POS_LR[1] * s, POS_LR[2], it))
        self.params, self.state = rl.adam(self.params, grads, self.state, lrs)
        return loss, grads


class Server:
    """The refined model served as free Gaussians: ``to_gaussian_arrays``
    as ``export_refined_ply`` writes them (log of the scales floored at
    1e-10), loaded as a ``GaussianModel`` and rendered by
    ``render_model`` at the settled caps, the image clipped and cast to
    uint8 as ``scripts/render.py`` does before its PNG encode."""

    def __init__(self, inp: dict):
        from sugar_tpu_torch.models.gaussians import GaussianModel, GaussianParams
        from sugar_tpu_torch.raster import adaptive
        from sugar_tpu_torch.refine import bound as B

        self._adaptive = adaptive
        params, bm = _program_bound(inp)
        with torch.no_grad():
            arrs = B.to_gaussian_arrays(params, bm)
            sh = arrs["sh"]
            gp = GaussianParams(
                xyz=arrs["centers"], sh_dc=sh[:, :, 0].contiguous(),
                sh_rest=sh[:, :, 1:].contiguous(), opacity_logit=params.opacity_logit,
                log_scales=torch.log(torch.clamp(arrs["scales"], min=1e-10)),
                quaternions=arrs["quaternions"])
        n = gp.xyz.shape[0]
        self.model = GaussianModel(params=gp, sh_degree=inp["sh_degree"],
                                   alive=torch.ones(n, dtype=torch.bool, device=gp.xyz.device))
        self.caps = adaptive.RasterCaps(tile_cap=16, dup_capacity=8 * n, k_max=1024)

    @torch.no_grad()
    def settle_caps(self, views: list) -> None:
        from sugar_tpu_torch.models.render import render_model

        for v in views:
            _, self.caps = self._adaptive.render_adaptive(render_model, self.caps, self.model,
                                                          program_camera(v))

    @torch.no_grad()
    def render(self, view: rr.View) -> tuple[torch.Tensor, dict]:
        """(uint8 (H, W, 3) image on the device, the render's output)."""
        from sugar_tpu_torch.models.render import render_model

        c = self.caps
        out = render_model(self.model, program_camera(view), dup_capacity=c.dup_capacity,
                           k_max=c.k_max, tile_cap=c.tile_cap, cap_a=c.cap_a, big_cap=c.big_cap)
        img = out["image"]
        return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8), out


@torch.no_grad()
def reference_image(inp: dict, view: rr.View, dev, dtype=torch.float32,
                    count: dict | None = None) -> torch.Tensor:
    """The served view in plain PyTorch: (H, W, 3) in ``dtype``."""
    leaves = {k: v.to(dtype) for k, v in reference_params(inp, dev).items()}
    view = view.to(leaves["vertices"].device, dtype)
    sc = reference_screen(leaves, inp, view, inp["sh_degree"])
    if count is not None:
        count["visible"] = int(sc.visible.sum())
    bg = torch.zeros(3, dtype=dtype, device=leaves["vertices"].device)
    return rr.render(sc, view, bg, count)[0]


def extra_ops(inp: dict, count: dict) -> int:
    """fp32 operations of one refinement step outside the compositing
    kernels: per face the bound Gaussian (centroid 6, normal and base
    vectors ~45, the complex rotation ~12, scales ~4, the covariance from
    the rotation ~30: ~100 forward, twice that backward), per visible
    Gaussian the projection, SH degree 3 and activations (~245 forward,
    twice that backward), per adjacent face pair the normal consistency
    (~8, ~16 backward), Adam ~12 per parameter."""
    params = sum(inp[k].numel() for k in ("complex_rot", "opacity_logit", "sh_rest"))
    params += inp["vertices"].numel() + 2 * inp["faces"].shape[0] + 3 * inp["faces"].shape[0]
    return (300 * inp["faces"].shape[0] + 735 * count["visible"] + 24 * inp["pairs"].shape[0]
            + 12 * params)


def serve_extra_ops(inp: dict, count: dict) -> int:
    """fp32 operations of one served view outside the compositing kernel:
    the projection, SH degree 3 and activations per visible Gaussian
    (~290, from a quaternion), and the clip and scale to uint8 per pixel
    and channel (3)."""
    return 290 * count["visible"] + 3 * 3 * count["pixels"]
