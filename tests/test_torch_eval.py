"""The port's evaluation against the JAX package: ``evaluate_renders``
(PSNR, SSIM, LPIPS with synthetic VGG weights, the ``lpips_uncalibrated``
labelling), ``_weights_calibrated``, ``write_metrics_json``,
``make_parity_scene`` at a toy size and ``eval_gaussian_ply``.

Tolerances: PSNR and SSIM atol 1e-5; LPIPS rtol 1e-4; the parity scene's
points, colours and extent equal, its GT images atol 1e-5 against the JAX
package's renders of the same model (its ``tiled`` mode; the port renders
through the fused path's plain version).
"""

import json

import numpy as np
import pytest
import torch

from sugar_tpu.eval import metrics as jmetrics
from sugar_tpu.eval import parity as jparity
from sugar_tpu.models import gaussians as jgm
from sugar_tpu_torch.eval import metrics, parity
from sugar_tpu_torch.models import gaussians as gm

torch.set_num_threads(1)


def lpips_weights(path, calibrated=None, seed=0):
    """tests/test_aux.py:193-218's synthetic VGG16 weights."""
    rng = np.random.default_rng(seed)
    w, idx, cin, heads = {}, 0, 3, []
    for c in metrics._VGG_CFG:
        if c == "M":
            idx += 1
            continue
        w[f"features.{idx}.weight"] = rng.normal(scale=0.05, size=(c, cin, 3, 3)).astype(np.float32)
        w[f"features.{idx}.bias"] = rng.normal(scale=0.01, size=(c,)).astype(np.float32)
        cin = c
        idx += 2
        if idx - 1 in (3, 8, 15, 22, 29):
            heads.append(c)
    for k, c in enumerate(heads):
        w[f"lin{k}"] = rng.uniform(0, 2.0 / c, (c,)).astype(np.float32)
    if calibrated is not None:
        w["calibrated"] = np.asarray(int(calibrated), np.int32)
    np.savez(path, **w)
    return path


def images(n=3, hw=32, seed=1):
    g = np.random.default_rng(seed)
    base = g.uniform(0, 1, (n, hw, hw, 3)).astype(np.float32)
    return list(base), [np.clip(b + g.normal(0, 0.1, b.shape), -0.1, 1.1).astype(np.float32)
                        for b in base]


def test_vgg_layout_matches_jax():
    assert metrics._VGG_CFG == jmetrics._VGG_CFG and metrics._SLICE_ENDS == jmetrics._SLICE_ENDS
    np.testing.assert_array_equal(metrics._SHIFT, jmetrics._SHIFT)
    np.testing.assert_array_equal(metrics._SCALE, jmetrics._SCALE)


@pytest.mark.parametrize("calibrated", [None, True, False])
def test_evaluate_renders_matches_jax(tmp_path, calibrated):
    gts, renders = images()
    path = lpips_weights(str(tmp_path / "w.npz"), calibrated)
    j = jmetrics.evaluate_renders(lambda i: renders[i], gts, [0, 2], path)
    t = metrics.evaluate_renders(lambda i: torch.as_tensor(renders[i]), gts, [0, 2], path)
    key = "lpips" if calibrated in (None, True) else "lpips_uncalibrated"
    assert set(t) == set(j) and key in t and t["n_images"] == 2
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(t[k], j[k], atol=1e-5, rtol=0)
        np.testing.assert_allclose(t[f"per_image_{k}"], j[f"per_image_{k}"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(t[key], j[key], rtol=1e-4)
    assert t[key] > 0


def test_evaluate_renders_without_lpips():
    gts, renders = images(2)
    t = metrics.evaluate_renders(lambda i: renders[i], gts, [1])
    j = jmetrics.evaluate_renders(lambda i: renders[i], gts, [1])
    assert set(t) == set(j) == {"psnr", "ssim", "n_images", "per_image_psnr", "per_image_ssim"}
    np.testing.assert_allclose(t["psnr"], j["psnr"], atol=1e-5)
    empty = metrics.evaluate_renders(lambda i: renders[i], gts, [])
    assert np.isnan(empty["psnr"]) and empty["n_images"] == 0


def test_lpips_self_distance_and_missing_weights(tmp_path):
    lp = metrics.make_lpips(lpips_weights(str(tmp_path / "w.npz")))
    a = np.random.default_rng(0).uniform(0, 1, (40, 40, 3)).astype(np.float32)
    flag = torch.backends.cudnn.allow_tf32
    assert float(lp(a, a)) < 1e-6
    assert torch.backends.cudnn.allow_tf32 == flag  # turned off for the call only
    assert metrics.make_lpips(str(tmp_path / "missing.npz")) is None


def test_weights_calibrated_matches_jax(tmp_path):
    cases = {"w.npz": dict(calibrated=np.asarray(1, np.int32)),
             "w2.npz": dict(calibrated=np.asarray(0, np.int32)),
             "w.uncalibrated.npz": dict(lin0=np.zeros(3, np.float32)),
             "legacy.npz": dict(lin0=np.zeros(3, np.float32))}
    for name, arrays in cases.items():
        path = str(tmp_path / name)
        np.savez(path, **arrays)
        assert metrics._weights_calibrated(path) == jmetrics._weights_calibrated(path), name
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not an npz")
    assert metrics._weights_calibrated(str(bad)) is jmetrics._weights_calibrated(str(bad)) is False


def test_write_metrics_json_merges_as_jax(tmp_path):
    out = {}
    for pkg, writer in (("jax", jmetrics.write_metrics_json), ("port", metrics.write_metrics_json)):
        path = str(tmp_path / pkg / "results.json")
        writer(path, "lego", {"gaussians": {"psnr": 30.0}})
        writer(path, "garden", {"refined": {"psnr": 25.5, "ssim": 0.8}})
        writer(path, "lego", {"textured": {"psnr": 20.0}})
        with open(path) as f:
            out[pkg] = f.read()
    assert out["port"] == out["jax"]
    assert json.loads(out["port"]) == {"lego": {"textured": {"psnr": 20.0}},
                                       "garden": {"refined": {"psnr": 25.5, "ssim": 0.8}}}
    broken = tmp_path / "broken.json"
    broken.write_text("{not json")
    metrics.write_metrics_json(str(broken), "s", {"a": 1})
    assert json.loads(broken.read_text()) == {"s": {"a": 1}}


PARITY = dict(n_gt=300, n_init=120, n_cams=9, resolution=32, k_max=256)
_cache = {}


def parity_pair():
    if "scene" not in _cache:
        _cache["scene"] = (jparity.make_parity_scene(render_mode="tiled", **PARITY),
                           parity.make_parity_scene(device="cpu", **PARITY))
    return _cache["scene"]


def test_make_parity_scene_matches_jax():
    (js, jtarget), (ts, ttarget) = parity_pair()
    np.testing.assert_array_equal(ts.points, js.points)
    np.testing.assert_array_equal(ts.colors, js.colors)
    assert ts.extent == js.extent and ts.image_names == js.image_names
    for f in jgm.GaussianParams.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(ttarget.params, f).numpy(),
                                      np.asarray(getattr(jtarget.params, f)), err_msg=f)
    assert len(ts.images) == len(js.images) == PARITY["n_cams"]
    for c_t, c_j in zip(ts.cameras, js.cameras):
        np.testing.assert_array_equal(c_t.full_proj.numpy(), np.asarray(c_j.full_proj))
    for a, b in zip(ts.images, js.images):
        assert a.shape == (32, 32, 3) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    assert max(float(a.max()) for a in ts.images) > 0.3
    assert ts.split(True) == js.split(True) == ([1, 2, 3, 4, 5, 6, 7], [0, 8])


def test_eval_gaussian_ply_matches_jax(tmp_path):
    (js, jtarget), (ts, _) = parity_pair()
    ply = str(tmp_path / "target.ply")
    jgm.save_ply(jtarget, ply)
    # A coarser copy: a model that does not fit the images exactly.
    m = gm.load_ply(ply, device="cpu")
    noisy = str(tmp_path / "noisy.ply")
    params = m.params
    g = np.random.default_rng(0)
    xyz = params.xyz + torch.as_tensor(g.normal(0, 0.02, tuple(params.xyz.shape)), dtype=torch.float32)
    gm.save_ply(gm.GaussianModel(type(params)(**{**params.__dict__, "xyz": xyz}), m.alive,
                                 m.sh_degree), noisy)
    _, test_idx = ts.split(True)
    for path, exact in ((ply, True), (noisy, False)):
        j = jparity.eval_gaussian_ply(path, js, test_idx, render_mode="tiled", k_max=64)
        t = parity.eval_gaussian_ply(path, ts, test_idx, k_max=64)
        assert t["n_images"] == j["n_images"] == 2
        np.testing.assert_allclose(t["ssim"], j["ssim"], atol=1e-5)
        np.testing.assert_allclose(t["psnr"], j["psnr"], rtol=1e-4)
        assert (t["psnr"] > 60) == exact
