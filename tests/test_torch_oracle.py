"""The port's oracle raster modes against sugar_tpu's, on the CPU.

``raster/composite.py``, ``raster/reference_impl.py``, ``raster/binning.py``,
``raster/tiled.py``, ``raster/twopass.py`` and ``dup_gather.
gather_dup_searchsorted`` get the same numpy inputs as their JAX
counterparts (the JAX two-pass path and segment sum in Pallas interpret
mode).

Tolerances: images and final_T atol 1e-5 (the oracle, float64 numpy, 2e-4
as tests/test_raster.py holds it); n_contrib and every counter equal;
binning bit-equal; gradients 2e-5 x max|g| per input.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from oracle_raster import oracle_render
from test_raster import make_scene, make_settings
from sugar_tpu.raster import binning as jbinning
from sugar_tpu.raster import composite as jcomp
from sugar_tpu.raster.api import rasterize_gaussians as jrasterize
from sugar_tpu.raster.pallas_render import gather_dup_searchsorted as jgather_ss
from sugar_tpu.raster.preprocess import preprocess as jpreprocess
from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.raster import binning as tbinning
from sugar_tpu_torch.raster import composite as tcomp
from sugar_tpu_torch.raster.api import rasterize_gaussians
from sugar_tpu_torch.raster.common import from_camera
from sugar_tpu_torch.raster.dup_gather import gather_dup_searchsorted
from sugar_tpu_torch.raster.preprocess import Preprocessed

torch.set_num_threads(2)

INPUTS = ("means", "scales", "quats", "opac", "colors")
GRAD_RTOL = 2e-5


def settings_pair(h, w, bg=(0.0, 0.0, 0.0)):
    """The same camera in both packages (tests/test_raster.py's)."""
    cam = make_camera(R=np.eye(3), T=np.zeros(3), fov_x=1.2, fov_y=1.0, height=h, width=w,
                      device="cpu")
    return make_settings(h=h, w=w, bg=bg), from_camera(cam, bg=torch.tensor(bg, dtype=torch.float32))


def render_pair(arrays, h, w, mode, bg=(0.0, 0.0, 0.0), weights_seed=None, **kw):
    """(JAX output, port output[, JAX grads, port grads]) of one render of
    ``arrays`` (make_scene's tuple). With ``weights_seed`` the loss is
    sum(image * W) for a seeded W and the gradients of the five inputs
    come back too."""
    jst, tst = settings_pair(h, w, bg)

    def jrun(*a):
        out = jrasterize(a[0], a[3], jst, scales=a[1], quaternions=a[2], colors=a[4], mode=mode,
                         **kw)
        return out

    def trun(*a):
        return rasterize_gaussians(a[0], a[3], tst, scales=a[1], quaternions=a[2], colors=a[4],
                                   mode=mode, **kw)

    jargs = [jnp.asarray(x) for x in arrays]
    targs = [torch.tensor(x, requires_grad=weights_seed is not None) for x in arrays]
    with pltpu.force_tpu_interpret_mode():
        if weights_seed is None:
            return jax.jit(jrun)(*jargs), trun(*targs)
        wts = np.random.default_rng(weights_seed).normal(size=(h, w, 3)).astype(np.float32)

        def jloss(*a):
            out = jrun(*a)
            return jnp.sum(out["image"] * wts), out

        # One trace for the render and its gradient.
        (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=range(5), has_aux=True))(
            *jargs)
    tout = trun(*targs)
    (tout["image"] * torch.tensor(wts)).sum().backward()
    return jout, tout, [np.asarray(g) for g in jgrads], [a.grad.numpy() for a in targs]


_cache = {}


def cached(name, fn):
    if name not in _cache:
        _cache[name] = fn()
    return _cache[name]


def assert_render_close(j, t, atol=1e-5):
    np.testing.assert_allclose(t["image"].detach().numpy(), np.asarray(j["image"]), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(t["final_T"].detach().numpy(), np.asarray(j["final_T"]), atol=atol,
                               rtol=0)
    np.testing.assert_array_equal(t["n_contrib"].numpy(), np.asarray(j["n_contrib"]))
    np.testing.assert_array_equal(t["radii"].numpy(), np.asarray(j["radii"]))
    for k in j:
        if k not in ("image", "final_T", "n_contrib", "radii"):
            assert int(t[k]) == int(j[k]), k


def assert_grads_close(jg, tg):
    for name, a, b in zip(INPUTS, jg, tg):
        scale = float(np.abs(a).max())
        assert scale > 0.0, name
        np.testing.assert_allclose(b, a, atol=GRAD_RTOL * scale, rtol=0, err_msg=name)


# --- composite.py ---------------------------------------------------------


def composite_inputs(k=300, p=40, c=3, seed=0):
    g = np.random.default_rng(seed)
    mean2d = g.uniform(0, 16, (k, 2)).astype(np.float32)
    a = g.uniform(0.05, 0.6, k)
    cc = g.uniform(0.05, 0.6, k)
    b = g.uniform(-0.8, 0.8, k) * np.sqrt(a * cc)
    conic = np.stack([a, b, cc], -1).astype(np.float32)
    opacity = g.uniform(0.05, 1.0, k).astype(np.float32)
    opacity[:20] = 1.0  # clamped at 0.99 near their centres
    pix = np.stack([g.integers(0, 16, p), g.integers(0, 16, p)], -1).astype(np.float32)
    valid = g.uniform(size=k) > 0.1
    color = g.uniform(0, 1, (k, c)).astype(np.float32)
    bg = np.array([0.2, 0.5, 0.7], np.float32)
    wimg = g.normal(size=(p, c)).astype(np.float32)
    wt = g.normal(size=p).astype(np.float32)
    return mean2d, conic, opacity, pix, valid, color, bg, wimg, wt


@pytest.mark.parametrize("block", [256, 128, 64])
def test_composite_functions_match_jax(block):
    """alpha_from_conic -> composite_depth_ordered (whose blocks run
    composite_block): values and the gradients of mean2d, conic, opacity
    and color, over several blocks with early stops inside them."""
    mean2d, conic, opacity, pix, valid, color, bg, wimg, wt = composite_inputs()

    def jrun(m, q, o, c):
        alpha = jcomp.alpha_from_conic(m, q, o, jnp.asarray(pix), jnp.asarray(valid))
        return alpha, jcomp.composite_depth_ordered(alpha, c, jnp.asarray(bg), block=block)

    def jloss(*a):
        _, (img, ft, _) = jrun(*a)
        return jnp.sum(img * wimg) + jnp.sum(ft * wt)

    jargs = [jnp.asarray(x) for x in (mean2d, conic, opacity, color)]
    j_alpha, (j_img, j_ft, j_n) = jrun(*jargs)
    j_grads = jax.grad(jloss, argnums=range(4))(*jargs)

    targs = [torch.tensor(x, requires_grad=True) for x in (mean2d, conic, opacity, color)]
    t_alpha = tcomp.alpha_from_conic(*targs[:3], torch.tensor(pix), torch.tensor(valid))
    t_img, t_ft, t_n = tcomp.composite_depth_ordered(t_alpha, targs[3], torch.tensor(bg),
                                                     block=block)
    ((t_img * torch.tensor(wimg)).sum() + (t_ft * torch.tensor(wt)).sum()).backward()

    np.testing.assert_allclose(t_alpha.detach().numpy(), np.asarray(j_alpha), atol=1e-6, rtol=0)
    assert float(t_alpha.detach().max()) == pytest.approx(0.99)  # the clamp is reached
    np.testing.assert_allclose(t_img.detach().numpy(), np.asarray(j_img), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_ft.detach().numpy(), np.asarray(j_ft), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t_n.numpy(), np.asarray(j_n))
    # Some pixels stop early (T_EPS), others composite all 300 slots.
    assert float(t_ft.detach().min()) < 1e-3 < float(t_ft.detach().max())
    for name, a, t in zip(("mean2d", "conic", "opacity", "color"), j_grads, targs):
        a = np.asarray(a)
        np.testing.assert_allclose(t.grad.numpy(), a, atol=GRAD_RTOL * float(np.abs(a).max()),
                                   rtol=0, err_msg=name)


def test_composite_block_matches_jax_with_carry():
    """One block with a carried-in transmittance: every output and the
    carry gradients."""
    mean2d, conic, opacity, pix, valid, color, *_ = composite_inputs(k=64, seed=1)
    alpha = np.asarray(jcomp.alpha_from_conic(*(jnp.asarray(x) for x in
                                               (mean2d, conic, opacity, pix, valid))))
    g = np.random.default_rng(2)
    log_t = g.uniform(-3.0, 0.0, pix.shape[0]).astype(np.float32)
    log_p = (log_t - g.uniform(0.0, 2.0, pix.shape[0])).astype(np.float32)
    ws = [g.normal(size=s).astype(np.float32) for s in ((pix.shape[0], 3),) + ((pix.shape[0],),) * 2]

    def jloss(a, c, lt):
        out = jcomp.composite_block(a, c, lt, jnp.asarray(log_p))
        return jnp.sum(out[0] * ws[0]) + jnp.sum(out[1] * ws[1]) + jnp.sum(out[2] * ws[2])

    jargs = [jnp.asarray(x) for x in (alpha, color, log_t)]
    j_out = jcomp.composite_block(*jargs, jnp.asarray(log_p))
    j_grads = jax.grad(jloss, argnums=range(3))(*jargs)
    targs = [torch.tensor(x, requires_grad=True) for x in (alpha, color, log_t)]
    t_out = tcomp.composite_block(*targs, torch.tensor(log_p))
    sum((o * torch.tensor(w)).sum() for o, w in zip(t_out[:3], ws)).backward()
    for a, b in zip(t_out, j_out):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5, rtol=0)
    assert t_out[3].dtype == torch.int32 and int(t_out[3].max()) > 0
    for a, t in zip(j_grads, targs):
        a = np.asarray(a)
        np.testing.assert_allclose(t.grad.numpy(), a, atol=GRAD_RTOL * float(np.abs(a).max()),
                                   rtol=0)


# --- reference_impl.py ----------------------------------------------------


def reference_pair():
    return cached("reference", lambda: (make_scene(n=200, seed=1),) + render_pair(
        make_scene(n=200, seed=1), 48, 64, "reference", weights_seed=3))


def test_render_reference_matches_jax():
    _, j, t, _, _ = reference_pair()
    assert_render_close(j, t)
    assert float(t["final_T"].detach().min()) < 0.5


def test_render_reference_gradients_match_jax():
    _, _, _, jg, tg = reference_pair()
    assert_grads_close(jg, tg)


def test_render_reference_matches_the_oracle():
    arrays, _, t, _, _ = reference_pair()
    jst, _ = settings_pair(48, 64)
    means, scales, quats, opac, colors = (x.astype(np.float64) for x in arrays)
    oracle = oracle_render(
        means, scales, quats, opac, colors, np.asarray(jst.viewmatrix, np.float64),
        np.asarray(jst.projmatrix, np.float64), jst.image_width, jst.image_height,
        jst.tanfovx, jst.tanfovy, np.zeros(3),
    )
    np.testing.assert_allclose(t["image"].detach().numpy(), oracle["image"], atol=2e-4)
    np.testing.assert_allclose(t["final_T"].detach().numpy(), oracle["final_T"], atol=2e-4)


# --- binning.py -----------------------------------------------------------


def jax_prep(seed, h, w, n=300, ties=False):
    means, scales, quats, opac, colors = make_scene(n=n, seed=seed)
    if ties:
        # Equal f32 depths across Gaussians (identity view: depth = z).
        means[:, 2] = np.round(means[:, 2] * 2.0) / 2.0
    st = make_settings(h=h, w=w)
    prep = jpreprocess(jnp.asarray(means), jnp.asarray(opac), st, scales=jnp.asarray(scales),
                       quaternions=jnp.asarray(quats), colors=jnp.asarray(colors))
    if ties:
        depth = np.array(prep.depth)
        depth[:4] = [-0.0, 0.0, -0.0, np.inf]  # signed zeros tie; inf sorts last
        depth[4:8] = np.inf
        prep = dataclasses.replace(prep, depth=jnp.asarray(depth))
    return prep, st


def to_torch_prep(jprep) -> Preprocessed:
    return Preprocessed(**{
        k: torch.from_numpy(np.array(getattr(jprep, k))) for k in Preprocessed.__dataclass_fields__
    })


# name -> (seed, h, w, ties, dense tile_cap or None, capacity)
BIN_CASES = {
    "tiled": (11, 64, 80, False, None, 8192),
    "tiled_ties": (12, 64, 80, True, None, 8192),
    "tiled_capacity": (13, 64, 80, False, None, 500),
    "dense": (11, 64, 80, False, 16, None),
    "dense_ties": (12, 64, 80, True, 16, None),
    "dense_tile_cap": (14, 64, 80, False, 4, None),
    "dense_capacity": (15, 48, 96, False, 16, 700),
}
BIN_FIELDS = ("sorted_gauss", "sorted_tile", "tile_start", "tile_count", "num_rendered",
              "overflow")


@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_binning_bit_equal_to_jax(case):
    seed, h, w, ties, tile_cap, capacity = BIN_CASES[case]
    jprep, st = jax_prep(seed, h, w, ties=ties)
    tprep = to_torch_prep(jprep)
    _, tst = settings_pair(h, w)
    if tile_cap is None:
        jb = jbinning.bin_gaussians(jprep, st, capacity)
        tb = tbinning.bin_gaussians(tprep, tst, capacity)
    else:
        jb = jbinning.bin_gaussians_dense(jprep, st, tile_cap, capacity=capacity)
        tb = tbinning.bin_gaussians_dense(tprep, tst, tile_cap, capacity=capacity)
    for f in BIN_FIELDS:
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)),
                                      err_msg=f)
    for f in ("sorted_gauss", "sorted_tile", "tile_start", "tile_count"):
        assert getattr(tb, f).dtype == torch.int32, f
    # Each case exercises what it names.
    overflow, rendered = int(tb.overflow), int(tb.num_rendered)
    if "capacity" in case or "tile_cap" in case:
        assert overflow > 0
    else:
        assert overflow == 0 and rendered > 500
    if ties:
        d = tprep.depth[tprep.tiles_touched > 0]
        assert len(torch.unique(d)) < len(d) and bool(torch.isinf(d).any())
    if tile_cap is not None and capacity is None:
        n = tprep.depth.shape[0]
        assert bool((tb.sorted_gauss[rendered:] == n).all()) and int(tb.sorted_gauss.max()) == n


# --- tiled.py -------------------------------------------------------------

TILED_KW = dict(dup_capacity=16 * 300, k_max=256)


def tiled_pair():
    return cached("tiled", lambda: render_pair(make_scene(n=300, seed=2), 48, 64, "tiled",
                                               bg=(0.2, 0.3, 0.4), weights_seed=4, **TILED_KW))


def test_render_tiled_matches_jax():
    j, t, _, _ = tiled_pair()
    assert_render_close(j, t)
    assert int(t["tile_overflow"]) == 0 and int(t["bin_overflow"]) == 0


def test_render_tiled_gradients_match_jax():
    _, _, jg, tg = tiled_pair()
    assert_grads_close(jg, tg)


def test_render_tiled_matches_reference():
    """tests/test_raster.py's test_tiled_vs_reference, in the port."""
    arrays = [torch.tensor(x) for x in make_scene(n=300, seed=2)]
    _, tst = settings_pair(48, 64, (0.2, 0.3, 0.4))
    kw = dict(scales=arrays[1], quaternions=arrays[2], colors=arrays[4])
    ref = rasterize_gaussians(arrays[0], arrays[3], tst, mode="reference", **kw)
    tiled = rasterize_gaussians(arrays[0], arrays[3], tst, mode="tiled", **TILED_KW, **kw)
    np.testing.assert_allclose(tiled["image"].numpy(), ref["image"].numpy(), atol=1e-5)
    np.testing.assert_allclose(tiled["final_T"].numpy(), ref["final_T"].numpy(), atol=1e-5)


def test_render_tiled_kmax_clip_matches_jax():
    """Tiles deeper than k_max keep their nearest slots in both packages."""
    j, t = cached("tiled_clip", lambda: render_pair(make_scene(n=500, seed=5, spread=0.4), 32,
                                                    32, "tiled", dup_capacity=8000, k_max=128))
    assert int(t["tile_overflow"]) > 0
    assert_render_close(j, t)


def tiled_loss(st, target):
    def loss(means, scales, quats, opac, colors):
        out = rasterize_gaussians(means, opac, st, scales=scales, quaternions=quats,
                                  colors=colors, mode="tiled", dup_capacity=2048, k_max=64)
        return ((out["image"] - target) ** 2).mean()
    return loss


def test_render_tiled_grads_match_finite_difference():
    """tests/test_raster.py's test_grads_match_finite_difference."""
    _, st = settings_pair(32, 32)
    target = torch.tensor(np.random.default_rng(0).uniform(0, 1, (32, 32, 3)).astype(np.float32))
    loss = tiled_loss(st, target)
    args = [torch.tensor(x, requires_grad=True) for x in make_scene(n=12, seed=6)]
    loss(*args).backward()
    g = np.random.default_rng(1)
    eps = 3e-3
    with torch.no_grad():
        for argi, a in enumerate(args):
            flat = a.detach().numpy().astype(np.float64).reshape(-1)
            for p in g.choice(flat.size, size=min(6, flat.size), replace=False):
                fd_args = []
                for sign in (1, -1):
                    x = flat.copy()
                    x[p] += sign * eps
                    pert = [b.detach() for b in args]
                    pert[argi] = torch.tensor(x.reshape(a.shape).astype(np.float32))
                    fd_args.append(float(loss(*pert)))
                fd = (fd_args[0] - fd_args[1]) / (2 * eps)
                an = float(a.grad.reshape(-1)[p])
                assert abs(fd - an) < 5e-3 * max(1.0, abs(fd), abs(an)) + 2e-4, (argi, p, fd, an)


def test_render_tiled_no_nan_grads_with_culled():
    """tests/test_raster.py's test_no_nan_grads_with_culled."""
    means, scales, quats, opac, colors = make_scene(n=40, seed=8)
    means[:10, 2] = -2.0  # behind the camera
    means[10:15, 2] = 0.1  # inside the near-cull band
    _, st = settings_pair(32, 32)
    args = [torch.tensor(x, requires_grad=True) for x in (means, scales, quats, opac, colors)]
    tiled_loss(st, torch.zeros(32, 32, 3))(*args).backward()
    for a in args:
        assert bool(torch.isfinite(a.grad).all())
    assert float(args[0].grad[15:].abs().max()) > 0.0


def test_alpha_gradient_finite_where_exp_overflows():
    """A gated sample whose exp(power) overflows adds no NaN to the
    gradient (autograd's exp backward multiplies by the result)."""
    mean2d = torch.tensor([[0.0, 0.0], [1.0, 1.0]], requires_grad=True)
    conic = torch.tensor([[-50.0, 0.0, -50.0], [0.5, 0.0, 0.5]], requires_grad=True)
    opacity = torch.tensor([0.9, 0.9], requires_grad=True)
    pix = torch.tensor([[40.0, 40.0]])
    alpha = tcomp.alpha_from_conic(mean2d, conic, opacity, pix, torch.tensor([True, True]))
    alpha.sum().backward()
    assert float(alpha[0, 0]) == 0.0
    for t in (mean2d, conic, opacity):
        assert bool(torch.isfinite(t.grad).all())


# --- twopass.py and gather_dup_searchsorted -------------------------------

TWOPASS_KW = dict(dup_capacity=4800, k_max=512, tile_cap=16)


def twopass_pair():
    return cached("twopass", lambda: render_pair(make_scene(n=300, seed=2), 48, 64,
                                                 "pallas_twopass", bg=(0.2, 0.3, 0.4),
                                                 weights_seed=5, **TWOPASS_KW))


def test_render_twopass_matches_jax():
    j, t, _, _ = twopass_pair()
    assert_render_close(j, t)
    assert int(t["num_rendered"]) > 600 and int(t["max_tiles_touched"]) > 4


def test_render_twopass_gradients_match_jax():
    _, _, jg, tg = twopass_pair()
    assert_grads_close(jg, tg)


def test_render_twopass_truncated_capacity_matches_jax():
    """Capacity below num_rendered: the same truncated image, the same
    counters (cap_overflow > 0), and zero gradients (grads_exact false)."""
    j, t, jg, tg = cached("twopass_cap", lambda: render_pair(
        make_scene(n=300, seed=2), 48, 64, "pallas_twopass", weights_seed=6, dup_capacity=400,
        k_max=512, tile_cap=16))
    assert int(t["cap_overflow"]) > 0
    assert_render_close(j, t)
    for a, b in zip(jg, tg):
        assert float(np.abs(a).max()) == 0.0 and float(np.abs(b).max()) == 0.0


def test_gather_dup_searchsorted_gradient_over_bands():
    """A gid multiset split into two bands (a Gaussian's slots in both, the
    sentinel n in both): the gradient summed over the bands equals JAX's
    and a dense index_add."""
    g = np.random.default_rng(7)
    # Every row live: the JAX backward reduces all rows, the port's only
    # the live ones (the padding rows are constants on the render path).
    n, rows, live = 50, 9, 9
    packed = g.normal(size=(rows, n)).astype(np.float32)
    gid = np.concatenate([g.integers(0, n, 700), np.full(60, n)]).astype(np.int32)
    g.shuffle(gid)
    bands = [gid[:380], gid[380:]]
    wts = [g.normal(size=(rows, len(b))).astype(np.float32) for b in bands]

    def jloss(p):
        return sum(jnp.sum(jgather_ss(p, jnp.asarray(b), n, live, 64) * w)
                   for b, w in zip(bands, wts))

    with pltpu.force_tpu_interpret_mode():
        jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(packed)))
    tp = torch.tensor(packed, requires_grad=True)
    outs = [gather_dup_searchsorted(tp, torch.tensor(b), n, live) for b in bands]
    np.testing.assert_array_equal(outs[0].detach().numpy(),
                                  packed[:, np.minimum(bands[0], n - 1)])
    sum((o * torch.tensor(w)).sum() for o, w in zip(outs, wts)).backward()
    dense = np.zeros((rows, n + 1), np.float64)
    for b, w in zip(bands, wts):
        np.add.at(dense.T, b, w.T.astype(np.float64))
    np.testing.assert_allclose(tp.grad.numpy(), jgrad, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tp.grad.numpy(), dense[:, :n], atol=1e-5, rtol=0)
    assert float(np.abs(jgrad).max()) > 0.0
