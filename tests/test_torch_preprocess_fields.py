"""``raster.preprocess.preprocess_fields``: the render's preprocess from the
model's raw fields.

- ``preprocess_fields_plain`` (the kernel's plain version) against the JAX
  package's activations plus ``preprocess`` on the same raw fields, field
  by field, with test_torch_preprocess.py's tolerances: SH degrees 0-3
  fully active and degree 1 active of 3, colours of width 1 and 8, dead
  slots, Gaussians behind the camera and outside the frustum, a non-zero
  ``ndc_offset``.
- On CPU tensors ``render_model`` and ``render_params`` give the outputs
  (and the gradients) of the composition they replaced, bit for bit.
- The backward's plain version (the autograd VJP of
  ``preprocess_fields_plain``) against the JAX package's ``jax.vjp`` of
  the activations plus ``preprocess``, per gradient, at SH degrees 0-4 and
  with a colours override, with culled and dead Gaussians, means clipped
  at the 1.3 tan limit, a zero-norm quaternion, colours clamped at 0 and
  an ``ndc_offset``: within 2e-5 x max|g| of each field (float32 VJPs
  that sum in other orders). At the zero-norm quaternion JAX's gradient is
  NaN (the norm's sqrt at 0); the port's is 0, the 1e-12 floor's branch.
- On CPU tensors ``render_bound`` (built scales and unit quaternions)
  gives the outputs and gradients of the ``to_gaussian_arrays`` +
  ``rasterize_gaussians`` composition it replaced, bit for bit.
- The route: with the device test stubbed, ``preprocess_fields_cuda`` is
  taken alone exactly when the render needs no gradient, and
  ``PreprocessFields`` (the kernel pair, its launchers stood in by the
  plain versions) otherwise, with the torch route's gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sugar_tpu.core.cameras import make_camera as jmake_camera
from sugar_tpu.core.quaternions import normalize as jquat_normalize
from sugar_tpu.raster import common as jrc
from sugar_tpu.raster import preprocess as jpre
from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.models.gaussians import GaussianModel, GaussianParams
from sugar_tpu_torch.models.render import render_model, render_params
from sugar_tpu_torch.raster import common as rc
from sugar_tpu_torch.raster import preprocess as tpre
from sugar_tpu_torch.raster.api import rasterize_gaussians
from sugar_tpu_torch.refine import bound as B
from sugar_tpu_torch.refine.trainer import render_bound
from sugar_tpu_torch.utils import profiling

torch.set_num_threads(1)

N, H, W = 240, 48, 64
CAM = dict(R=np.array([[0.995, 0.0, 0.0998], [0.0, 1.0, 0.0], [-0.0998, 0.0, 0.995]]),
           T=np.array([0.05, -0.1, 0.2]), fov_x=1.2, fov_y=1.0, height=H, width=W)
FIELDS = ("xyz", "sh_dc", "sh_rest", "opacity_logit", "log_scales", "quaternions")
PREP_FIELDS = [f.name for f in dataclasses.fields(tpre.Preprocessed)]
INT_FIELDS = {"radius", "rect_min", "rect_max", "tiles_touched"}

# name -> (model SH degree, active degree, colour width or None, dead
# slots, ndc_offset)
CASES = {
    "sh0": (0, 0, None, True, True),
    "sh1": (1, 1, None, True, True),
    "sh2": (2, 2, None, False, False),
    "sh3": (3, 3, None, True, True),
    "sh4": (4, 4, None, True, True),
    "sh1_of_3": (3, 1, None, True, False),
    "colors1": (3, 3, 1, True, True),
    "colors8": (3, 3, 8, False, True),
}


def raw_fields(degree: int, seed: int = 5, n: int = N) -> dict[str, np.ndarray]:
    """Raw fields of n Gaussians: most in front of the camera, an eighth
    behind it (z below the near cull) and an eighth far outside the
    frustum; raw quaternions of any norm."""
    g = np.random.default_rng(seed)
    z = g.uniform(1.0, 6.0, n)
    x, y = g.uniform(-1.2, 1.2, n), g.uniform(-1.2, 1.2, n)
    z[: n // 8] = g.uniform(-2.0, -0.3, n // 8)
    x[n // 8: n // 4] = g.choice([-1, 1], n // 8) * g.uniform(20.0, 60.0, n // 8)
    k = (degree + 1) ** 2
    return dict(
        xyz=np.stack([x, y, z], -1).astype(np.float32),
        sh_dc=g.normal(0, 0.8, (n, 3)).astype(np.float32),
        sh_rest=g.normal(0, 0.3, (n, 3, k - 1)).astype(np.float32),
        opacity_logit=g.normal(0, 2.0, n).astype(np.float32),
        log_scales=g.uniform(np.log(0.02), np.log(0.3), (n, 3)).astype(np.float32),
        quaternions=(g.normal(size=(n, 4)) * g.uniform(0.3, 3.0, (n, 1))).astype(np.float32),
    )


def case_inputs(case: str) -> dict:
    degree, active, ch, dead, offset = CASES[case]
    d = raw_fields(degree)
    g = np.random.default_rng(17)
    extra = dict(
        colors=g.uniform(0, 1, (N, ch)).astype(np.float32) if ch else None,
        alive=(g.uniform(size=N) > 0.15) if dead else None,
        ndc_offset=g.normal(0, 0.01, (N, 2)).astype(np.float32) if offset else None,
    )
    return dict(fields=d, active=active, **extra)


def jax_prep(inp: dict):
    d, k = inp["fields"], (inp["active"] + 1) ** 2
    js = dataclasses.replace(jrc.from_camera(jmake_camera(**CAM)), sh_degree=inp["active"])
    sh = jnp.concatenate([jnp.asarray(d["sh_dc"])[:, :, None], jnp.asarray(d["sh_rest"])], -1)

    def opt(name):
        return None if inp[name] is None else jnp.asarray(inp[name])

    return jpre.preprocess(
        jnp.asarray(d["xyz"]), jax.nn.sigmoid(jnp.asarray(d["opacity_logit"])), js,
        scales=jnp.exp(jnp.asarray(d["log_scales"])),
        quaternions=jquat_normalize(jnp.asarray(d["quaternions"])),
        colors=opt("colors"), shs=None if inp["colors"] is not None else sh[:, :, :k],
        alive_mask=opt("alive"), ndc_offset=opt("ndc_offset"),
    )


def torch_settings(active: int) -> rc.RasterSettings:
    return dataclasses.replace(rc.from_camera(make_camera(**CAM, device="cpu")),
                               sh_degree=active)


def plain_prep(inp: dict):
    t = {k: torch.tensor(v) for k, v in inp["fields"].items()}

    def opt(name):
        return None if inp[name] is None else torch.tensor(inp[name])

    return tpre.preprocess_fields_plain(
        *(t[f] for f in ("xyz", "opacity_logit", "log_scales", "quaternions", "sh_dc",
                         "sh_rest")),
        torch_settings(inp["active"]), alive_mask=opt("alive"), colors=opt("colors"),
        ndc_offset=opt("ndc_offset"),
    )


_preps = {}


def preps(case: str):
    if case not in _preps:
        inp = case_inputs(case)
        _preps[case] = (jax_prep(inp), plain_prep(inp))
    return _preps[case]


@pytest.mark.parametrize("field", PREP_FIELDS)
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax(case, field):
    jout, tout = preps(case)
    t, j = getattr(tout, field).numpy(), np.asarray(getattr(jout, field))
    assert t.shape == j.shape, (field, t.shape, j.shape)
    if field in INT_FIELDS:
        assert t.dtype == np.int32
        np.testing.assert_array_equal(t, j, err_msg=field)
    else:
        scale = float(np.max(np.abs(j))) if j.size else 1.0
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5 * scale, err_msg=field)


@pytest.mark.parametrize("case", list(CASES))
def test_cases_cull_what_they_should(case):
    """Behind-camera, off-frustum and dead Gaussians are culled; the rest
    mostly are not."""
    inp = case_inputs(case)
    tiles = preps(case)[1].tiles_touched.numpy()
    assert (tiles[: N // 4] == 0).all()
    if inp["alive"] is not None:
        assert (tiles[~inp["alive"]] == 0).all()
    assert (tiles[N // 4:] > 0).sum() > N // 2


# --- render_model / render_params against the composition they replaced ---

def model_of(degree: int = 3, requires_grad: bool = False) -> GaussianModel:
    d = raw_fields(degree, seed=9)
    params = GaussianParams(**{k: torch.tensor(v, requires_grad=requires_grad)
                               for k, v in d.items()})
    alive = torch.tensor(np.random.default_rng(3).uniform(size=N) > 0.1)
    return GaussianModel(params=params, alive=alive, sh_degree=degree)


RASTER_KW = dict(dup_capacity=8192, k_max=512)


def replaced_render(model, camera, active, bg=None, colors=None, ndc_offset=None):
    """``render_model``'s composition before ``preprocess_fields``: the
    activations and SH concat, then ``rasterize_gaussians``."""
    settings = dataclasses.replace(rc.from_camera(camera, bg=bg), sh_degree=active)
    k = (active + 1) ** 2
    p = model.params
    sh = torch.cat([p.sh_dc[:, :, None], p.sh_rest], dim=-1)
    return rasterize_gaussians(
        p.xyz, torch.sigmoid(p.opacity_logit), settings, scales=torch.exp(p.log_scales),
        quaternions=tpre.quat_normalize(p.quaternions), colors=colors,
        shs=None if colors is not None else sh[:, :, :k], alive_mask=model.alive,
        ndc_offset=ndc_offset, **RASTER_KW,
    )


def new_render(entry: str, model, camera, active, bg=None, colors=None, ndc_offset=None):
    if entry == "render_model":
        return render_model(model, camera, bg=bg, active_sh_degree=active,
                            colors_override=colors, ndc_offset=ndc_offset, **RASTER_KW)
    bg = torch.zeros(3)
    return render_params(model.params, model.alive, camera, active, bg, ndc_offset=ndc_offset,
                         **RASTER_KW)


def loss_of(out: dict) -> torch.Tensor:
    w = torch.linspace(0.5, 1.5, out["image"].numel()).reshape(out["image"].shape)
    return (out["image"] * w).sum()


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("variant", ["render_model", "render_params", "render_model_sh1",
                                     "render_model_colors"])
def test_cpu_renders_are_bit_equal_to_the_replaced_composition(variant, grad):
    entry = variant if variant == "render_params" else "render_model"
    active = 1 if variant.endswith("sh1") else 3
    g = np.random.default_rng(4)
    colors = (torch.tensor(g.uniform(0, 1, (N, 1)).astype(np.float32))
              if variant.endswith("colors") else None)
    bg = torch.full((1,), 0.25) if colors is not None else None
    offset = torch.zeros((N, 2), requires_grad=grad)
    cam = make_camera(**CAM, device="cpu")
    outs, grads = [], []
    for fn in (replaced_render, None):
        model = model_of(requires_grad=grad)
        with torch.set_grad_enabled(grad):
            if fn is None:
                out = new_render(entry, model, cam, active, bg=bg, colors=colors,
                                 ndc_offset=offset)
            else:
                out = fn(model, cam, active, bg=bg, colors=colors, ndc_offset=offset)
        outs.append(out)
        if grad:
            leaves = [getattr(model.params, f) for f in FIELDS] + [offset]
            grads.append(torch.autograd.grad(loss_of(out), leaves, allow_unused=True))
    want, got = outs
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert bool((want["radii"] > 0).sum() > N // 2)
    for gw, gg, name in zip(*grads, FIELDS + ("ndc_offset",)) if grad else ():
        assert (gw is None) == (gg is None), name
        assert gw is None or torch.equal(gw, gg), name


# --- the route ---

ROUTE_FIELDS = [None, *FIELDS, "ndc_offset"]


@pytest.fixture
def stubbed(monkeypatch):
    """The device test answers True for every tensor, and the kernels'
    launchers are stand-ins that record their calls and run the plain
    versions; ``PreprocessFields.apply`` records its calls too."""
    calls = dict(fwd=[], bwd=[], pair=[])

    def stand_in(*args, **kwargs):
        calls["fwd"].append(args)
        return tpre.preprocess_fields_plain(*args, **kwargs)

    def bwd_stand_in(*args, **kwargs):
        calls["bwd"].append(args)
        return tpre.preprocess_fields_bwd_plain(*args, **kwargs)

    apply = tpre.PreprocessFields.apply

    def pair(*args):
        calls["pair"].append(args)
        return apply(*args)

    monkeypatch.setattr(tpre, "_on_card", lambda x: True)
    monkeypatch.setattr(tpre, "preprocess_fields_cuda", stand_in)
    monkeypatch.setattr(tpre, "preprocess_fields_bwd_cuda", bwd_stand_in)
    monkeypatch.setattr(tpre.PreprocessFields, "apply", pair)
    return calls


@pytest.mark.parametrize("requires", ROUTE_FIELDS, ids=lambda f: f or "none")
@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("entry", ["render_model", "render_params"])
def test_the_kernel_route_is_taken_exactly_when_no_gradient_is_needed(stubbed, entry, grad,
                                                                     requires):
    """On the card the forward kernel runs once in every render: alone
    when no gradient is needed, inside ``PreprocessFields`` otherwise."""
    model = model_of()
    offset = torch.zeros((N, 2))
    if requires == "ndc_offset":
        offset.requires_grad_(True)
    elif requires is not None:
        getattr(model.params, requires).requires_grad_(True)
    cam = make_camera(**CAM, device="cpu")
    with torch.set_grad_enabled(grad):
        out = new_render(entry, model, cam, 3, ndc_offset=offset)
    needs_grad = grad and requires is not None
    assert len(stubbed["fwd"]) == 1
    assert len(stubbed["pair"]) == (1 if needs_grad else 0)
    assert out["image"].requires_grad == needs_grad
    assert not stubbed["bwd"]


def test_the_cuda_wrapper_refuses_a_render_that_needs_a_gradient():
    model = model_of(requires_grad=True)
    p = model.params
    with pytest.raises(ValueError, match="no backward"):
        tpre.preprocess_fields_cuda(p.xyz, p.opacity_logit, p.log_scales, p.quaternions,
                                    p.sh_dc, p.sh_rest, torch_settings(3), alive_mask=model.alive)


def test_the_torch_route_counts_no_kernel_hit():
    """While a profiler collects, each render counts its route under
    ``raster.preprocess_kernel``: 0 on the torch route."""
    model = model_of()
    cam = make_camera(**CAM, device="cpu")
    profiling.reset()
    try:
        with torch.profiler.profile():
            with torch.no_grad():
                render_model(model, cam, **RASTER_KW)
            render_params(model.params, model.alive, cam, 3, torch.zeros(3), **RASTER_KW)
        hits = [c["value"] for c in profiling.recorded()["counters"]
                if c["name"] == "raster.preprocess_kernel"]
    finally:
        profiling.reset()  # leave no records to a later test in this process
    assert hits == [0, 0]


# --- the backward: the plain VJP against jax.vjp ---

GRAD_FIELDS = ("xyz", "opacity_logit", "log_scales", "quaternions", "sh_dc", "sh_rest", "colors",
               "ndc_offset")
ZERO_QUAT = N // 4  # the row whose raw quaternion is zero
OUT_FIELDS = ("mean2d", "conic", "opacity", "color")


def edge_inputs(case: str) -> dict:
    """``case_inputs`` with rows past the culled quarter set to the edges
    of the backward: a zero-norm quaternion, means in front of the camera
    but past the 1.3 tan clamp (large, so that some still touch tiles) and
    colours below 0 (SH DC -3, no rest), clamped."""
    inp = case_inputs(case)
    d = {k: v.copy() for k, v in inp["fields"].items()}
    r = ZERO_QUAT
    d["quaternions"][r] = 0.0
    d["xyz"][r + 1: r + 5, 0] = np.array([1.0, -1.0, 1.1, -1.2]) * d["xyz"][r + 1: r + 5, 2]
    d["xyz"][r + 5: r + 7, 1] = np.array([1.0, -1.1]) * d["xyz"][r + 5: r + 7, 2]
    d["log_scales"][r + 1: r + 7] = np.log(2.0)
    d["sh_dc"][r + 7: r + 11] = -3.0
    d["sh_rest"][r + 7: r + 11] = 0.0
    inp["fields"] = d
    g = np.random.default_rng(23)
    ch = 3 if inp["colors"] is None else inp["colors"].shape[1]
    inp["cot"] = [g.normal(size=(N, 2)).astype(np.float32),
                  g.normal(size=(N, 3)).astype(np.float32),
                  g.normal(size=(N,)).astype(np.float32),
                  g.normal(size=(N, ch)).astype(np.float32)]
    return inp


def jax_grads(inp: dict) -> dict:
    """jax.vjp of the JAX package's activations + ``preprocess`` at the
    cotangents of mean2d, conic, opacity and color."""
    d, k = inp["fields"], (inp["active"] + 1) ** 2
    js = dataclasses.replace(jrc.from_camera(jmake_camera(**CAM)), sh_degree=inp["active"])
    names = [f for f in GRAD_FIELDS if f in d or inp.get(f) is not None]
    vals = [jnp.asarray(d[f] if f in d else inp[f]) for f in names]
    alive = None if inp["alive"] is None else jnp.asarray(inp["alive"])

    def f(*args):
        a = dict(zip(names, args))
        sh = jnp.concatenate([a["sh_dc"][:, :, None], a["sh_rest"]], -1)[:, :, :k]
        p = jpre.preprocess(
            a["xyz"], jax.nn.sigmoid(a["opacity_logit"]), js, scales=jnp.exp(a["log_scales"]),
            quaternions=jquat_normalize(a["quaternions"]), colors=a.get("colors"),
            shs=None if "colors" in a else sh, alive_mask=alive, ndc_offset=a.get("ndc_offset"))
        return tuple(getattr(p, o) for o in OUT_FIELDS)

    _, vjp = jax.vjp(f, *vals)
    grads = vjp(tuple(jnp.asarray(c) for c in inp["cot"]))
    return {n: np.asarray(g) for n, g in zip(names, grads)}


def plain_grads(inp: dict) -> dict:
    """``preprocess_fields_bwd_plain`` on the same fields and cotangents."""
    d = inp["fields"]
    t = {k: torch.tensor(v) for k, v in d.items()}

    def opt(name):
        return None if inp[name] is None else torch.tensor(inp[name])

    got = tpre.preprocess_fields_bwd_plain(
        *(torch.tensor(c) for c in inp["cot"]),
        *(t[f] for f in ("xyz", "opacity_logit", "log_scales", "quaternions", "sh_dc",
                         "sh_rest")),
        torch_settings(inp["active"]), alive_mask=opt("alive"), colors=opt("colors"),
        ndc_offset=opt("ndc_offset"))
    return {n: None if g is None else g.numpy() for n, g in zip(tpre.GRAD_FIELDS, got)}


_grads = {}


def grads_of(case: str):
    if case not in _grads:
        inp = edge_inputs(case)
        _grads[case] = (inp, jax_grads(inp), plain_grads(inp))
    return _grads[case]


@pytest.mark.parametrize("field", GRAD_FIELDS)
@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax_vjp(case, field):
    inp, jg, tg = grads_of(case)
    t = tg[field]
    if field not in jg:  # not an input of the render: no colours or no ndc_offset
        assert t is None
        return
    j = jg[field]
    if inp["colors"] is not None and field in ("sh_dc", "sh_rest"):
        assert t is None and not j.any()  # SH unread under a colours override
        return
    assert t is not None and t.shape == j.shape
    if field == "quaternions":
        # JAX's is NaN at the zero-norm row (the norm's sqrt at 0); the
        # port's is the unit quaternion's gradient over the 1e-12 floor
        # (torch.maximum passes the norm none of it), which is 0: every
        # derivative of the rotation is linear in the quaternion.
        assert np.isnan(j[ZERO_QUAT]).all()
        assert not t[ZERO_QUAT].any()
        t, j = np.delete(t, ZERO_QUAT, 0), np.delete(j, ZERO_QUAT, 0)
    scale = float(np.max(np.abs(j))) if j.size else 1.0
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-5 * scale, err_msg=field)


@pytest.mark.parametrize("case", list(CASES))
def test_backward_cases_reach_their_edges(case):
    """The edge rows do what they are for: clipped means (|t / z| past the
    1.3 tan limit), clamped colours (their colour gradient 0 for SH) and a
    zero-norm quaternion; culled rows of the JAX forward exist."""
    inp, _, tg = grads_of(case)
    d = inp["fields"]
    r = ZERO_QUAT
    lim = 1.3 * np.tan(np.array([CAM["fov_x"], CAM["fov_y"]]) / 2)
    over = np.abs(d["xyz"][r + 1: r + 7, :2] / d["xyz"][r + 1: r + 7, 2:]) > lim
    assert over.any(axis=1).all()
    assert not d["quaternions"][r].any()
    if inp["colors"] is None:
        assert (preps_of_edges(case).color.numpy()[r + 7: r + 11] == 0).all()
        assert not tg["sh_dc"][r + 7: r + 11].any()


def preps_of_edges(case: str):
    inp = edge_inputs(case)
    return plain_prep(inp)


# --- render_bound against the composition it replaced ---

def bound_scene(sh_degree: int, seed: int = 3):
    """A jittered 6 x 6 grid mesh at z ~ 2.5 in front of ``CAM``, bound one
    Gaussian a face, with random scales, rotations, opacities and SH."""
    g = np.random.default_rng(seed)
    xs = np.linspace(-1.0, 1.0, 6)
    verts = np.array([[x, y, 2.5] for x in xs for y in xs], np.float32)
    verts += g.uniform(-0.06, 0.06, verts.shape).astype(np.float32)
    faces = []
    for i in range(5):
        for j in range(5):
            a = i * 6 + j
            faces += [[a, a + 1, a + 6], [a + 1, a + 7, a + 6]]
    params, bm = B.init_bound_params(verts, np.array(faces), None, 1, extent=2.0,
                                     sh_degree=sh_degree, device="cpu")
    n = params.opacity_logit.shape[0]
    ang = g.uniform(0, 2 * np.pi, n)
    fields = dict(
        vertices=params.vertices,
        log_scales=params.log_scales + torch.tensor(g.normal(0, 0.3, (n, 2)), dtype=torch.float32),
        complex_rot=torch.tensor(np.stack([np.cos(ang), np.sin(ang)], -1), dtype=torch.float32),
        opacity_logit=torch.tensor(g.normal(0, 1, n), dtype=torch.float32),
        sh_dc=params.sh_dc + torch.tensor(g.normal(0, 0.3, (n, 3)), dtype=torch.float32),
        sh_rest=torch.tensor(g.normal(0, 0.2, tuple(params.sh_rest.shape)), dtype=torch.float32),
    )
    return fields, bm


def replaced_render_bound(params, bm, cam, active, bg):
    """``render_bound`` before ``preprocess_fields``: ``to_gaussian_arrays``
    then ``rasterize_gaussians``."""
    arrs = B.to_gaussian_arrays(params, bm)
    settings = dataclasses.replace(rc.from_camera(cam, bg=bg), sh_degree=active)
    k = (active + 1) ** 2
    return rasterize_gaussians(arrs["centers"], arrs["opacities"], settings, scales=arrs["scales"],
                               quaternions=arrs["quaternions"], shs=arrs["sh"][:, :, :k],
                               **RASTER_KW)


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("degrees", [(0, 0), (3, 3), (3, 1)], ids=["sh0", "sh3", "sh1_of_3"])
def test_cpu_render_bound_is_bit_equal_to_the_replaced_composition(degrees, grad):
    degree, active = degrees
    cam = make_camera(**CAM, device="cpu")
    bg = torch.full((3,), 0.2)
    outs, grads = [], []
    for fn in (replaced_render_bound, None):
        fields, bm = bound_scene(degree)
        leaves = {k: v.clone().requires_grad_(grad) for k, v in fields.items()}
        params = B.BoundParams(**leaves)
        with torch.set_grad_enabled(grad):
            if fn is None:
                out = render_bound(params, bm, cam, active, bg, **RASTER_KW)
            else:
                out = fn(params, bm, cam, active, bg)
        outs.append(out)
        if grad:
            grads.append(torch.autograd.grad(loss_of(out), list(leaves.values()),
                                             allow_unused=True))
    want, got = outs
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert bool((want["radii"] > 0).sum() > 25)
    for gw, gg, name in zip(*grads, B.BOUND_FIELDS) if grad else ():
        assert gw is not None and gg is not None, name
        assert torch.equal(gw, gg), name


# --- the kernel pair's wiring, with the launchers stood in by the plain versions ---

@pytest.mark.parametrize("entry", ["render_params", "render_model_colors", "render_bound"])
def test_the_kernel_pair_gives_the_torch_routes_gradients(stubbed, monkeypatch, entry):
    """Through ``PreprocessFields`` (forward and backward each launched
    once) a render's gradients are the torch route's, up to the order of
    float32 sums: within 1e-6 x max|g|."""
    cam = make_camera(**CAM, device="cpu")
    results = []
    for card in (True, False):
        monkeypatch.setattr(tpre, "_on_card", lambda x, card=card: card)
        if entry == "render_bound":
            fields, bm = bound_scene(3)
            leaves = {k: v.clone().requires_grad_(True) for k, v in fields.items()}
            out = render_bound(B.BoundParams(**leaves), bm, cam, 3, torch.zeros(3), **RASTER_KW)
            leaves = list(leaves.values())
        else:
            model = model_of(requires_grad=True)
            offset = torch.zeros((N, 2), requires_grad=True)
            colors = None
            if entry == "render_model_colors":
                colors = torch.tensor(np.random.default_rng(4).uniform(0, 1, (N, 2)),
                                      dtype=torch.float32, requires_grad=True)
                out = render_model(model, cam, bg=torch.full((2,), 0.25), colors_override=colors,
                                   ndc_offset=offset, **RASTER_KW)
            else:
                out = render_params(model.params, model.alive, cam, 3, torch.zeros(3),
                                    ndc_offset=offset, **RASTER_KW)
            leaves = [getattr(model.params, f) for f in FIELDS] + [offset]
            leaves += [] if colors is None else [colors]
        results.append((out, torch.autograd.grad(loss_of(out), leaves, allow_unused=True)))
    assert len(stubbed["pair"]) == len(stubbed["fwd"]) == len(stubbed["bwd"]) == 1
    (card_out, card_g), (cpu_out, cpu_g) = results
    assert torch.equal(card_out["image"], cpu_out["image"])
    for a, b in zip(card_g, cpu_g):
        assert (a is None) == (b is None)
        if a is not None:
            scale = float(b.abs().max())
            assert scale > 0
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * scale)
