"""The port's multi-device layer (``sugar_tpu_torch/parallel/``) against the
JAX package's, on the CPU: the tile-sharded render, the ring KNN and the
rank launcher (the sharded level set: tests/test_torch_parallel_meshing.py;
the sharded steps and loops: tests/test_torch_parallel_train.py).

The port's cases run in four ``gloo`` ranks (``parallel.launch.run_ranks``
on the CPU, one intra-op thread each), started once for the module by the
``port`` fixture; the tests then compare. The JAX side runs on the
virtual CPU devices of tests/conftest.py: a ("shard",) mesh of 4 devices.
This module imports JAX only inside its fixtures and tests, so the ranks,
which import it to find ``rank_cases``, never do.

Tolerances (tests/test_parallel.py, tests/test_pallas.py): images and
final_T atol 1e-5, n_contrib and the three overflow counters equal,
gradients of the five inputs within 2e-5 x max|g|; KNN distances rtol/atol
1e-5 and indices equal.
"""

import multiprocessing
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.parallel import comm
from sugar_tpu_torch.parallel.launch import RankError, run_ranks
from sugar_tpu_torch.parallel.mesh import Axis, make_mesh, new_axis, world_axis
from sugar_tpu_torch.parallel.render import gather_band, render_sharded
from sugar_tpu_torch.raster.common import from_camera

torch.set_num_threads(2)

WORLD = 4
H, W = 128, 64  # tests/test_parallel.py's TestShardedTileRender scene
BG = (0.15, 0.25, 0.35)
RENDER_KW = dict(tile_cap=40, k_max=512)
OVERFLOW_ROUTE_CAP = 256  # with the scales doubled, 266-302 slots per (rank, band 1)
INPUTS = ("means", "scales", "quats", "opac", "colors")
COUNTERS = ("route_overflow", "tile_overflow", "kmax_overflow")
KNN_CASES = {  # name: (queries, refs, k, masked share, seed, world)
    "w4_masked": (64, 96, 5, 0.2, 5, 4),
    "w3_uneven": (50, 71, 4, 0.0, 9, 3),
    "w4_self": (32, None, 3, 0.0, 7, 4),
    "w4_few_alive": (20, 40, 5, 0.93, 13, 4),
}


def camera(device="cpu"):
    return make_camera(R=np.eye(3), T=np.zeros(3), fov_x=1.2, fov_y=1.0, height=H, width=W,
                       device=device)


def knn_inputs(name):
    nq, nr, k, masked, seed, world = KNN_CASES[name]
    g = np.random.default_rng(seed)
    q = g.normal(size=(nq, 3)).astype(np.float32)
    r = q if nr is None else g.normal(size=(nr, 3)).astype(np.float32)
    mask = g.uniform(size=len(r)) >= masked
    if name == "w4_few_alive":
        mask[:] = False
        mask[[3, 17, 30]] = True  # 3 alive references for k = 5
    return q, r, k, mask, world


def doubled(arrays):
    """The scene with its scales doubled (more slots per band)."""
    m, s, q, o, c = arrays
    return m, 2 * s, q, o, c


def _render_case(dev, axis, arrays, tgt, **kw):
    """One world render and its gradients, gathered whole on every rank."""
    st = from_camera(camera(dev), bg=torch.tensor(BG), device=dev)
    xs = [torch.tensor(a, device=dev).requires_grad_(True) for a in arrays]
    out = render_sharded(axis, xs[0], xs[3], st, scales=xs[1], quaternions=xs[2], colors=xs[4],
                         **RENDER_KW, **kw)
    img = gather_band(out["image"], axis, st)
    loss = ((img - torch.tensor(tgt, device=dev)) ** 2).mean()
    grads = [comm.all_reduce(g, axis) for g in torch.autograd.grad(loss, xs)]
    return dict(
        image=img.detach(),
        final_T=gather_band(out["final_T"].detach(), axis, st),
        n_contrib=gather_band(out["n_contrib"], axis, st),
        counters={k: int(out[k]) for k in COUNTERS},
        grads=grads,
    )


def rank_cases(dev, arrays, tgt):
    """Every port case of this module, in one rank (run_ranks entry)."""
    from sugar_tpu_torch.parallel.knn import knn_sharded

    axis = world_axis()
    comm.reset_counters()
    res = dict(render=_render_case(dev, axis, arrays, tgt), bytes=comm.counters())
    res["overflow"] = _render_case(dev, axis, doubled(arrays), tgt, route_cap=OVERFLOW_ROUTE_CAP)
    three = new_axis(range(3))  # every rank creates the group; rank 3 is outside it
    res["knn"] = {}
    for name in KNN_CASES:
        q, r, k, mask, world = knn_inputs(name)
        ax = axis if world == WORLD else three
        if ax is None:
            continue
        d, i = knn_sharded(ax, torch.tensor(q, device=dev), torch.tensor(r, device=dev), k,
                           ref_mask=torch.tensor(mask, device=dev))
        res["knn"][name] = (d, i)
    return res


@pytest.fixture(scope="module")
def scene():
    from test_raster import make_scene

    arrays = make_scene(n=512, seed=11)
    tgt = np.random.default_rng(0).uniform(0, 1, (H, W, 3)).astype(np.float32)
    return arrays, tgt


@pytest.fixture(scope="module")
def port(scene):
    return run_ranks(rank_cases, WORLD, device="cpu", args=scene, threads=1)


@pytest.fixture(scope="module")
def jax_render(scene):
    """JAX's render_sharded (its pure-JAX compositor, use_kernel=False) on
    a 4-device ("shard",) mesh: outputs and gradients, and the outputs
    with the overflowing route_cap."""
    import jax
    import jax.numpy as jnp

    from sugar_tpu.parallel.render import render_sharded as jrender_sharded
    from test_raster import make_settings

    arrays, tgt = scene
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:WORLD]), ("shard",))
    st = make_settings(h=H, w=W, bg=BG)
    args = tuple(jnp.asarray(x) for x in arrays)

    def run(route_cap=None):
        def f(m, s, q, o, c):
            return jrender_sharded(mesh, "shard", m, o, st, scales=s, quaternions=q, colors=c,
                                   use_kernel=False, route_cap=route_cap, **RENDER_KW)
        return f

    def loss(*a):
        out = run()(*a)
        return jnp.mean((out["image"] - jnp.asarray(tgt)) ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                                 has_aux=True))(*args)
    ovf = jax.jit(run(OVERFLOW_ROUTE_CAP))(*(jnp.asarray(x) for x in doubled(arrays)))
    host = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return host(out), [np.asarray(g) for g in grads], host(ovf)


def test_render_sharded_matches_jax(port, jax_render):
    j, _, _ = jax_render
    t = port["render"]
    np.testing.assert_allclose(t["image"].numpy(), j["image"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(t["final_T"].numpy(), j["final_T"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t["n_contrib"].numpy(), j["n_contrib"])
    assert t["counters"] == {k: int(j[k]) for k in COUNTERS} == dict.fromkeys(COUNTERS, 0)
    assert float(j["final_T"].min()) < 0.5  # the scene covers part of the frame


@pytest.mark.parametrize("i", range(len(INPUTS)), ids=INPUTS)
def test_render_sharded_gradients_match_jax(port, jax_render, i):
    jg = jax_render[1][i]
    tg = port["render"]["grads"][i].numpy()
    scale = float(np.abs(jg).max())
    assert scale > 0
    np.testing.assert_allclose(tg, jg, atol=2e-5 * scale, rtol=0)


def test_render_sharded_route_overflow_counters_match_jax(port, jax_render):
    """With the scales doubled and route_cap 256 the routing blocks drop
    slots: which ones depends on the unstable sort by tile, so only the
    counters are compared."""
    j = jax_render[2]
    t = port["overflow"]["counters"]
    assert t == {k: int(j[k]) for k in COUNTERS}
    assert t["route_overflow"] > 0


def test_render_sharded_collective_bytes(port):
    """Per rank, one render and its backward: the packed rows gathered
    ((9, 512) float32), the three routing arrays exchanged (4 blocks of
    route_cap slots, 4 bytes each), the counters summed, the packed
    cotangent reduce-scattered (9, 128), and the test's own gathers and
    gradient sums."""
    b = port["bytes"]
    route_cap = 2560  # default_route_cap(512, 4, 40)
    assert b["all_to_all"] == 3 * WORLD * route_cap * 4
    assert b["reduce_scatter"] == 9 * 128 * 4
    assert b["all_gather"] >= 9 * 512 * 4
    assert b["host_staged"] == 0  # CPU tensors are not staged


def test_world_three_raises_as_jax():
    """tiles_y = 8 does not divide among 3 ranks: both packages refuse,
    with the same message, before any collective."""
    import jax
    import jax.numpy as jnp

    from sugar_tpu.parallel.render import render_sharded as jrender_sharded
    from test_raster import make_scene, make_settings

    arrays = make_scene(n=512, seed=11)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:3]), ("shard",))
    with pytest.raises(ValueError) as je:
        jrender_sharded(mesh, "shard", jnp.asarray(arrays[0]), jnp.asarray(arrays[3]),
                        make_settings(h=H, w=W, bg=BG))
    three = Axis(group=None, ranks=(0, 1, 2), index=0, backend="gloo")
    st = from_camera(camera(), bg=torch.tensor(BG))
    with pytest.raises(ValueError) as te:
        render_sharded(three, torch.tensor(arrays[0]), torch.tensor(arrays[3]), st)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("name", list(KNN_CASES))
def test_knn_sharded_matches_single_chip_jax(port, name):
    import jax.numpy as jnp

    from sugar_tpu.fields.knn import knn as jknn

    q, r, k, mask, _ = knn_inputs(name)
    jd, ji = jknn(jnp.asarray(q), jnp.asarray(r), k=k, ref_mask=jnp.asarray(mask))
    td, ti = port["knn"][name]
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if name == "w4_self":
        # Self first, at distance 0 up to the float32 formula's rounding.
        np.testing.assert_array_equal(ti[:, 0].numpy(), np.arange(len(q)))
        assert float(td[:, 0].max()) < 1e-5
    if name == "w4_few_alive":
        # 3 alive references for k = 5: the single-chip (+inf, 0) slots.
        assert np.isinf(td[:, 3:].numpy()).all() and (ti[:, 3:] == 0).all()


def raise_on_rank_one(dev):
    """run_ranks entry: rank 1 raises while rank 0 waits in a barrier."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()
    return "unreachable"


def test_a_failing_rank_raises_in_the_caller():
    t0 = time.perf_counter()
    with pytest.raises(RankError, match="rank 1 fails on purpose"):
        run_ranks(raise_on_rank_one, 2, device="cpu", threads=1)
    assert time.perf_counter() - t0 < 60
    assert multiprocessing.active_children() == []


def test_make_mesh_defaults_to_the_ranks_card(tmp_path, monkeypatch):
    """Without ``device`` the mesh lives on the rank's CUDA card
    (``launch.rank_device``), as the JAX mesh takes the real devices; with
    no card that default raises, and the CPU is asked for by name."""
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        assert make_mesh(device="cpu").device == torch.device("cpu")
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make_mesh()
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        assert make_mesh().device == torch.device("cuda", 0)
    finally:
        dist.destroy_process_group()
