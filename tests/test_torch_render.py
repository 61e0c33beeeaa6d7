"""The slice end to end: sugar_tpu_torch.models.render.render_model on the
CPU against sugar_tpu's render_model(mode="pallas") (Pallas kernel in
interpret mode), on a small SH-degree-3 model with dead padding slots.

Tolerances: image and final_T atol 1e-5; n_contrib, radii and every
overflow counter exactly equal. PLY files cross between the packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from test_raster import make_scene
from sugar_tpu.core.cameras import make_camera as jmake_camera
from sugar_tpu.eval import parity as jparity
from sugar_tpu.models import gaussians as jgm
from sugar_tpu.models.render import render_model as jrender_model
from sugar_tpu.raster import adaptive as jadaptive
from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.eval import parity as tparity
from sugar_tpu_torch.interop import model_from_numpy, params_from_numpy
from sugar_tpu_torch.models import gaussians as tgm
from sugar_tpu_torch.models.render import render_model, render_params
from sugar_tpu_torch.raster import adaptive
from sugar_tpu_torch.raster.api import resolve_mode
from sugar_tpu_torch.scripts import bench as tbench

torch.set_num_threads(2)

N, CAPACITY, H, W = 300, 320, 64, 80
CAM = dict(
    R=np.array([[0.995, 0.0, 0.0998], [0.0, 1.0, 0.0], [-0.0998, 0.0, 0.995]]),
    T=np.array([0.05, -0.1, 0.2]), fov_x=1.2, fov_y=1.0, height=H, width=W,
)
BG = np.array([0.1, 0.2, 0.3], np.float32)
RENDER_KW = dict(dup_capacity=8192, k_max=512)


def model_arrays(n=N, capacity=CAPACITY, seed=31, spread=1.2):
    """Raw fields of a padded SH-degree-3 model (JAX padding conventions)."""
    means, scales, quats, opac, colors = make_scene(n=n, seed=seed, spread=spread)
    g = np.random.default_rng(seed)
    d = dict(
        xyz=means,
        sh_dc=((colors - 0.5) / 0.28209479177387814).astype(np.float32),
        sh_rest=g.normal(0, 0.2, (n, 3, 15)).astype(np.float32),
        opacity_logit=np.log(opac / (1 - opac)).astype(np.float32),
        log_scales=np.log(scales).astype(np.float32),
        quaternions=quats,
    )
    fill = dict(opacity_logit=-10.0, log_scales=-10.0)
    for k, v in d.items():
        pad = np.full((capacity - n,) + v.shape[1:], fill.get(k, 0.0), np.float32)
        d[k] = np.concatenate([v, pad])
    d["quaternions"][n:, 0] = 1.0
    alive = np.arange(capacity) < n
    return d, alive


def jax_model(d, alive):
    return jgm.GaussianModel(
        params=jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in d.items()}),
        alive=jnp.asarray(alive), sh_degree=3,
    )


def jax_render(model, **kw):
    with pltpu.force_tpu_interpret_mode():
        return jrender_model(model, jmake_camera(**CAM), bg=jnp.asarray(BG), mode="pallas", **kw)


def port_render(model, **kw):
    return render_model(model, make_camera(**CAM, device="cpu"), bg=torch.tensor(BG), **kw)


_cache = {}


def cached(name, fn):
    if name not in _cache:
        _cache[name] = fn()
    return _cache[name]


def main_pair():
    def run():
        d, alive = model_arrays()
        return jax_render(jax_model(d, alive), **RENDER_KW), port_render(
            model_from_numpy(d, alive, 3, device="cpu"), **RENDER_KW
        )
    return cached("main", run)


def assert_same_render(t, j):
    np.testing.assert_allclose(t["image"].numpy(), np.asarray(j["image"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t["final_T"].numpy(), np.asarray(j["final_T"]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t["n_contrib"].numpy(), np.asarray(j["n_contrib"]))


@pytest.mark.parametrize("key", ["image", "final_T", "n_contrib", "radii"])
def test_render_model_matches_jax(key):
    j, t = main_pair()
    got, want = t[key].numpy(), np.asarray(j[key])
    assert got.shape == want.shape
    if key in ("n_contrib", "radii"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_render_overflow_counters_match_jax():
    j, t = main_pair()
    assert adaptive.read_overflow(t) == jadaptive.read_overflow(j)


def test_render_is_nontrivial():
    j, t = main_pair()
    assert float(t["final_T"].min()) < 0.5 and int(t["n_contrib"].max()) > 5
    assert int((t["radii"][N:] != 0).sum()) == 0  # dead slots are culled


def test_kmax_clip_matches_jax():
    """Tiles deeper than k_max keep their nearest slots, as in the JAX path;
    the clip shows in tile_overflow."""
    def run():
        d, alive = model_arrays(seed=32, spread=0.4)
        kw = dict(dup_capacity=8192, k_max=256)
        return jax_render(jax_model(d, alive), **kw), port_render(
            model_from_numpy(d, alive, 3, device="cpu"), **kw
        )
    j, t = cached("kmax", run)
    assert int(t["tile_overflow"]) > 0
    assert_same_render(t, j)
    assert adaptive.read_overflow(t) == jadaptive.read_overflow(j)


def test_ply_from_jax_renders_the_same(tmp_path):
    j, _ = main_pair()
    d, alive = model_arrays()
    path = str(tmp_path / "jax.ply")
    jgm.save_ply(jax_model(d, alive), path)
    loaded = tgm.load_ply(path, device="cpu")
    assert loaded.sh_degree == 3 and int(loaded.n_alive) == N
    assert_same_render(port_render(loaded, **RENDER_KW), j)


def test_ply_from_port_renders_the_same_in_jax(tmp_path):
    j, _ = main_pair()
    d, alive = model_arrays()
    path = str(tmp_path / "port.ply")
    tgm.save_ply(model_from_numpy(d, alive, 3, device="cpu"), path)
    loaded = jgm.load_ply(path)
    for k in tgm.PARAM_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(loaded.params, k))[:N], d[k][:N])
    jt = jax_render(loaded, **RENDER_KW)
    np.testing.assert_array_equal(np.asarray(jt["image"]), np.asarray(j["image"]))


def test_render_adaptive_grows_to_the_uncapped_render():
    d, alive = model_arrays()
    model = model_from_numpy(d, alive, 3, device="cpu")
    cam = make_camera(**CAM, device="cpu")
    events = []
    out, caps = adaptive.render_adaptive(
        render_model, adaptive.RasterCaps(tile_cap=4, dup_capacity=256, k_max=256, big_cap=4),
        model, cam, log_fn=events.append,
    )
    assert events and not adaptive.overflowed(adaptive.read_overflow(out))
    ref = render_model(model, cam, dup_capacity=1 << 16, k_max=4096, tile_cap=64)
    assert torch.equal(out["image"], ref["image"])
    assert torch.equal(out["n_contrib"], ref["n_contrib"])


def test_cap_state_observes_and_grows():
    d, alive = model_arrays()
    model = model_from_numpy(d, alive, 3, device="cpu")
    state = adaptive.CapState(adaptive.RasterCaps(tile_cap=4, dup_capacity=256, k_max=256))
    out = render_model(model, make_camera(**CAM, device="cpu"), tile_cap=4,
                       dup_capacity=256, k_max=256)
    assert state.observe(out) and state.version == 1
    assert state.caps.dup_capacity > 256 and state.caps.tile_cap > 4
    assert len(state.grow_events) == 1 and len(state.key()) == 5


def test_cap_state_lagged_cadence():
    """``check_lagged`` over 80 iterations from 7: every step observed for
    50 iterations after the start or a growth, then every 10th, each time
    on the previous step's counters. Step 20 overflows (growth at 21, hot
    until 71), step 74's overflow is skipped by the cadence, and steps 79
    and 80 overflow at the old caps, so the caps grow twice (80 and 81)."""
    start, stop = 7, 87
    overflowing = {20, 74, 79, 80}

    def aux(it):
        over = it in overflowing
        return dict(num_rendered=torch.tensor(2000 if over else 500),
                    cap_overflow=torch.tensor(976 if over else 0),
                    bin_overflow=torch.tensor(976 if over else 0),
                    tile_overflow=torch.tensor(0))

    state = adaptive.CapState(adaptive.RasterCaps(dup_capacity=1024))
    observed, grew, caps = [], [], []
    observe = state.observe
    state.observe = lambda a: observed.append(it) or observe(a)
    for it in range(start, stop):
        if state.check_lagged(it, aux(it)):
            grew.append(it)
            caps.append(state.caps.dup_capacity)

    # The rule the loops inlined before CapState owned it.
    want_observed, want_grew, prev, hot_until = [], [], None, start + 50
    for it in range(start, stop):
        if prev is not None and (it < hot_until or it % 10 == 0):
            want_observed.append(it)
            if prev in overflowing:
                want_grew.append(it)
                hot_until = it + 50
        prev = it
    assert observed == want_observed == [*range(8, 71), *range(80, 87)]
    assert grew == want_grew == [21, 80, 81]
    assert caps == [2560, 2816, 3072] and state.version == 3


def test_render_params_equals_render_model():
    d, alive = model_arrays()
    model = model_from_numpy(d, alive, 3, device="cpu")
    cam = make_camera(**CAM, device="cpu")
    a = render_model(model, cam, bg=torch.tensor(BG), **RENDER_KW)
    b = render_params(model.params, model.alive, cam, 3, torch.tensor(BG), **RENDER_KW)
    assert torch.equal(a["image"], b["image"])


def test_modes():
    """Every mode of the JAX package resolves to itself and renders JAX's
    image (its fused Pallas render, in interpret mode): the oracle modes
    and the two-pass path agree with it at 1e-5, n_contrib equal."""
    assert resolve_mode("auto") == "pallas"
    for mode in ("pallas", "reference", "tiled", "pallas_twopass"):
        assert resolve_mode(mode) == mode
    with pytest.raises(ValueError):
        resolve_mode("bogus")
    j, _ = main_pair()
    d, alive = model_arrays()
    m = model_from_numpy(d, alive, 3, device="cpu")
    for mode in ("reference", "tiled", "pallas_twopass"):
        t = port_render(m, mode=mode, **RENDER_KW)
        assert_same_render(t, j)
        np.testing.assert_array_equal(t["radii"].numpy(), np.asarray(j["radii"]))


def test_interop_requires_every_field():
    d, _ = model_arrays()
    del d["sh_rest"]
    with pytest.raises(KeyError, match="sh_rest"):
        params_from_numpy(d, device="cpu")


def test_chip_smoke_scene_is_the_bench_scene():
    """chip_smoke's scene is the port's bench scene (``scripts/bench.py``,
    whose blob builders are ``eval/parity.py``'s), and those builders
    equal the JAX package's."""
    assert chip_smoke.bench is tbench
    d = tparity._fibonacci_sphere(1000)
    np.testing.assert_array_equal(d, jparity._fibonacci_sphere(1000))
    np.testing.assert_array_equal(tparity.blob_surface(d), jparity.blob_surface(d))
    np.testing.assert_array_equal(tparity.blob_colors(d), jparity.blob_colors(d))
    arrays = chip_smoke.scene_params(2000, 1, 3)
    assert arrays["sh_rest"].shape == (2000, 3, 15)
    assert all(v.dtype == np.float32 for v in arrays.values())
