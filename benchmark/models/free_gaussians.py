"""Free 3DGS Gaussians (configuration kind ``free_gaussians``): the vanilla
model that SuGaR takes as input.

``build`` makes the model's parameters on the device from the seed: the
trained-statistics scene copied from the port's bench (``frozen.
scene_trained``) in a padded capacity, SH degree 3 with small random
higher bands. ``Program`` drives the port's train step
(``trainers.vanilla.make_train_step``) with the loop's own host work;
``Reference`` follows it in plain PyTorch.
"""

from __future__ import annotations

import torch

from benchmark import frozen, scenes
from benchmark.drivers import train as loop
from benchmark.reference import losses as rl
from benchmark.reference import raster as rr

FIELDS = ("xyz", "sh_dc", "sh_rest", "opacity_logit", "log_scales", "quaternions")
# get_expon_lr_func's position rates and the constant rates of the other
# groups (gaussian_splatting/arguments/__init__.py).
POS_LR = (0.00016, 0.0000016, 30_000)
LRS = dict(sh_dc=0.0025, sh_rest=0.0025 / 20.0, opacity_logit=0.05, log_scales=0.005,
           quaternions=0.001)
# Inputs the benchmark keeps on the host once the program has its own.
HOST_KEYS = ("params",)


def build(cfg: dict, seed: int, device, role: str = "train") -> dict:
    """The benchmark's inputs: float32 parameters (capacity rows, the first
    ``alive`` live), the alive mask, the training views, their targets and
    the scene extent."""
    n, cap = cfg["alive"], cfg["capacity"]
    k = (cfg["sh_degree"] + 1) ** 2
    g = scenes.generator(seed, 1, device)
    means, scales, quats, opac, colors = frozen.scene_trained(n, g, cfg["center"], device)

    def pad(x, fill):
        out = torch.full((cap,) + x.shape[1:], fill, dtype=torch.float32, device=device)
        out[:n] = x
        return out

    sh_rest = torch.randn((cap, 3, k - 1), generator=g, device=device) * cfg["sh_rest_std"]
    params = dict(
        xyz=pad(means, 0.0),
        sh_dc=pad((colors - 0.5) / rr.SH_C0, 0.0),
        sh_rest=sh_rest,
        opacity_logit=pad(torch.log(opac / (1.0 - opac)), -10.0),
        log_scales=pad(torch.log(scales), -10.0),
        quaternions=pad(quats, 0.0),
    )
    params["quaternions"][n:, 0] = 1.0
    views = scenes.spiral_views(cfg)
    return dict(params=params, alive=torch.arange(cap, device=device) < n,
                views=[v.to(device) for v in views],
                targets=scenes.targets(cfg, views, device) if role == "train" else None,
                extent=scenes.extent(views), sh_degree=cfg["sh_degree"])


def program_camera(view: rr.View):
    from sugar_tpu_torch.core.cameras import Camera

    return Camera(world_view=view.viewmatrix, full_proj=view.projmatrix, cam_center=view.campos,
                  height=view.height, width=view.width, tan_half_fov_x=view.tanfovx,
                  tan_half_fov_y=view.tanfovy)


class Program:
    """The port's vanilla trainer state and its loop body
    (``trainers/vanilla.py`` ``train_vanilla_3dgs``) from ``start``, with
    the densify statistics and without densify events."""

    def __init__(self, inp: dict, traffic: dict):
        from sugar_tpu_torch.models import densifier as dens
        from sugar_tpu_torch.models.gaussians import GaussianParams
        from sugar_tpu_torch.raster import adaptive
        from sugar_tpu_torch.trainers import optimizer as opt
        from sugar_tpu_torch.trainers.schedule import CameraSchedule
        from sugar_tpu_torch.trainers.vanilla import TrainConfig, make_train_step

        self._make_step = make_train_step
        self._adaptive = adaptive
        p = inp["params"]
        cap = p["xyz"].shape[0]
        self.cfg = TrainConfig(capacity=cap, sh_degree=inp["sh_degree"])
        self.params = GaussianParams(**{f: p[f].clone() for f in FIELDS})
        self.alive = inp["alive"]
        self.adam = opt.init_adam(self.params)
        self.stats = dens.DensifyStats.zeros(cap, device=self.alive.device)
        self.lrs = opt.group_lrs(self.cfg.optim, spatial_lr_scale=inp["extent"])
        self.cap_state = adaptive.CapState(adaptive.RasterCaps(
            tile_cap=traffic["tile_cap"], dup_capacity=self.cfg.dup_capacity_mult * cap, k_max=self.cfg.k_max))
        self.sched = CameraSchedule(loop.SCHEDULE_SEED, len(inp["views"]))
        self.cams = [program_camera(v) for v in inp["views"]]
        self.targets = inp["targets"]
        self.step_cache = {}
        self.prev_aux = None
        self.hot_until = traffic["start_iteration"] + loop.HOT_STEPS
        self.beta1 = self.cfg.optim.beta1

    def _deg(self, it: int) -> int:
        return min(it // self.cfg.sh_warmup_every, self.cfg.sh_degree)

    @torch.no_grad()
    def settle_caps(self) -> None:
        """One forward pass over the distinct views, growing the caps until
        none overflows (``raster.adaptive.render_adaptive``)."""
        from sugar_tpu_torch.models.render import render_params

        bg = torch.zeros(3, device=self.alive.device)
        caps = self.cap_state.caps
        for cam in self.cams:
            _, caps = self._adaptive.render_adaptive(
                render_params, caps, self.params, self.alive, cam, self.cfg.sh_degree, bg)
        self.cap_state.caps = caps

    def step_fn(self, it: int):
        key = (self._deg(it), self.cap_state.key())
        if key not in self.step_cache:
            self.step_cache[key] = self._make_step(self.cfg, self.lrs, key[0], self.cap_state.caps)
        return self.step_cache[key]

    def warm_up(self, it: int) -> None:
        """One call of the step on iteration ``it``'s view; its outputs are
        dropped (the step leaves its inputs unchanged)."""
        ci = self.sched.index(it)
        self.step_fn(it)(self.params, self.alive, self.adam, self.stats, self.cams[ci],
                         self.targets[ci], it)

    def iterate(self, it: int) -> tuple[int, dict]:
        """One iteration of the loop: (view index, the step's aux)."""
        step = self.step_fn(it)
        ci = self.sched.index(it)
        self.params, self.adam, self.stats, aux = step(
            self.params, self.alive, self.adam, self.stats, self.cams[ci], self.targets[ci], it)
        loop.lagged_check(self, it, aux)
        return ci, aux

    def leaves(self) -> dict:
        return {f: getattr(self.params, f) for f in FIELDS}

    def first_grad(self) -> dict:
        """The gradient of step 1, worked out from Adam's first moment
        after it (mu = (1 - beta1) g from zero)."""
        return {f: getattr(self.adam.mu, f) / (1.0 - self.beta1) for f in FIELDS}


class Reference:
    """The same training in plain PyTorch: render, loss, backward, Adam.
    ``dtype`` bfloat16 renders and takes the loss in bfloat16 (the
    control); ``half`` takes the loss over the top half of the image only
    (a planted fault)."""

    def __init__(self, inp: dict, dev, dtype=torch.float32, half: bool = False):
        self.alive = inp["alive"].to(dev)
        self.params = {f: inp["params"][f].to(dev, copy=True) for f in FIELDS}
        self.views = inp["views"]
        self.targets = inp["targets"]
        self.extent = inp["extent"]
        self.deg = inp["sh_degree"]
        self.dtype, self.half = dtype, half
        self.state = rl.adam_init(self.params)

    def render(self, leaves: dict, view: rr.View) -> rr.Screen:
        q = leaves["quaternions"]
        q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
        cov = rr.cov_from_quaternions(torch.exp(leaves["log_scales"]), q)
        sh = torch.cat([leaves["sh_dc"][:, :, None], leaves["sh_rest"]], -1)
        return rr.project(leaves["xyz"], cov, torch.sigmoid(leaves["opacity_logit"]), view,
                          sh=sh, sh_degree=self.deg, alive=self.alive)

    def step(self, it: int, vi: int, count: dict | None = None) -> tuple[float, dict]:
        """One training step on view ``vi``: (loss, the gradient Adam got)."""
        view = self.views[vi].to(self.alive.device, self.dtype)
        leaves = {f: p.detach().to(self.dtype).requires_grad_(True) for f, p in self.params.items()}
        sc = self.render(leaves, view)
        if count is not None:
            count["visible"] = int(sc.visible.sum())
        bg = torch.zeros(3, dtype=self.dtype, device=self.alive.device)
        img, groups = rr.render(sc, view, bg, count)
        img = img.detach().requires_grad_(True)
        gt = self.targets[vi].to(self.dtype)
        rows = img.shape[0] // 2 if self.half else img.shape[0]
        loss = rl.rgb_loss(img[:rows], gt[:rows])
        loss.backward()
        rr.backward(sc, view, bg, groups, img.grad)
        grads = {f: (leaves[f].grad if leaves[f].grad is not None
                     else torch.zeros_like(leaves[f])).to(torch.float32) for f in FIELDS}
        lrs = dict(LRS, xyz=rl.expon_lr(POS_LR[0] * self.extent, POS_LR[1] * self.extent,
                                        POS_LR[2], it))
        self.params, self.state = rl.adam(self.params, grads, self.state, lrs)
        return float(loss.detach()), grads


def extra_ops(inp: dict, count: dict) -> int:
    """fp32 operations of one step outside the compositing kernels: per
    visible Gaussian the covariance from a quaternion and scales (~45), the
    EWA projection and conic (~75), the radius and rect (~20), SH degree 3
    (16 basis terms ~40, 3 x 16 multiply-adds 96) and the activations
    (~15), ~290 forward and twice that backward; Adam, ~12 per parameter;
    the densify statistics, ~6 per Gaussian."""
    params = sum(p.numel() for p in inp["params"].values())
    return 870 * count["visible"] + 12 * params + 6 * inp["params"]["xyz"].shape[0]
