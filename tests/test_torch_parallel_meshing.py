"""The port's sharded level set (``parallel/meshing.py``) against the JAX
package's, on the CPU: ``collect_surface_points_sharded`` over four
``gloo`` ranks against the JAX package's sharded collection (8 virtual
devices, tests/test_parallel.py's case) and its single-device
``collect_surface_points``: points 1e-5, normals 1e-4, Gaussian ids equal.
"""

import numpy as np

from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.interop import model_from_numpy
from sugar_tpu_torch.parallel.meshing import collect_surface_points_sharded

WORLD = 4


def levelset_scene():
    """tests/test_parallel.py's TestShardedMeshing scene: 96 Gaussians on a
    sphere shell in 128 slots, 5 ring cameras at 24x24."""
    g = np.random.default_rng(3)
    u = g.normal(size=(96, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = (u * 0.8).astype(np.float32)
    cols = g.uniform(0.2, 1, (96, 3)).astype(np.float32)
    poses = []
    for i in range(5):
        th = 2 * np.pi * i / 5
        fwd = -np.array([np.cos(th), 0.1, np.sin(th)])
        fwd /= np.linalg.norm(fwd)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        rwc = np.stack([right, np.cross(fwd, right), fwd], 0)
        poses.append(dict(R=rwc.T, T=-rwc @ (-fwd * 3), fov_x=1.0, fov_y=1.0, height=24,
                          width=24))
    return pts, cols, poses


LEVELSET_KW = dict(surface_level=0.3, total_points=2000, dup_capacity=4096, k_max=256)


def test_collect_surface_points_sharded_matches_jax():
    """World 4 over 5 cameras (the last group padded) against the JAX
    package's sharded (8 devices, tests/test_parallel.py) and
    single-device clouds."""
    import jax

    from sugar_tpu.core.cameras import make_camera as jmake_camera
    from sugar_tpu.meshing.levelset import collect_surface_points as jcollect
    from sugar_tpu.models import gaussians as jgm
    from sugar_tpu.parallel.meshing import collect_surface_points_sharded as jcollect_sharded

    pts, cols, poses = levelset_scene()
    jm = jgm.create_from_pcd(pts, cols, 128, sh_degree=0, initial_opacity=0.95)
    jcams = [jmake_camera(**p) for p in poses]
    ref = jcollect(jm, jcams, rng=np.random.default_rng(9), **LEVELSET_KW)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]), ("data",))
    jsh = jcollect_sharded(mesh, "data", jm, jcams, rng=np.random.default_rng(9), **LEVELSET_KW)
    f = {k: np.asarray(getattr(jm.params, k)) for k in jm.params.__dataclass_fields__}
    tm = model_from_numpy(f, np.asarray(jm.alive), 0, device="cpu")
    tcams = [make_camera(device="cpu", **p) for p in poses]
    t = collect_surface_points_sharded(WORLD, tm, tcams, rng=np.random.default_rng(9),
                                       device="cpu", **LEVELSET_KW)
    assert len(ref["points"]) > 50 and len(t["overflow"]) == 5
    assert t["launches"] == [(0,) * 6] * WORLD  # CPU tensors run the plain versions
    for other in (ref, jsh):
        np.testing.assert_allclose(t["points"], other["points"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(t["normals"], other["normals"], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(t["gaussian_idx"], other["gaussian_idx"])
