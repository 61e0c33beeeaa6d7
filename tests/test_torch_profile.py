"""The port's profiles and microbenches against the JAX package's scripts,
on the CPU at a small size.

- ``scripts/profile_raster.stages`` (preprocess, dense binning, the dup
  gather, the compositing kernel) and ``scripts/profile_trained.stages``
  (preprocess, the fused binning, pack + gather, the compositing kernel)
  on bench.py's scenes at n 4,096 and 64x64, stage by stage against the
  JAX scripts' calls of ``sugar_tpu`` (Pallas in interpret mode): float
  stage outputs rtol 1e-5 (atol 1e-5 x max|x|), images atol 1e-5, ints,
  counters, dup order and n_contrib equal. Each stage-by-stage image
  equals the port's one-call render of the same path exactly.
- Every operation the microbenches time, on small inputs, against the
  ``jax.lax`` / ``jnp`` call the JAX scripts time: sorted keys, stable
  payloads, gathers and integer results exactly (an unstable sort's
  payload as a multiset per key), float sums within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sugar_tpu.core.cameras import make_camera as jmake_camera
from sugar_tpu.raster import fused as jfused
from sugar_tpu.raster.binning import bin_gaussians_dense as jdense
from sugar_tpu.raster.common import from_camera as jfrom_camera
from sugar_tpu.raster.pallas_composite import C_CHUNK, ROWS
from sugar_tpu.raster.pallas_composite import tile_composite as jtile_composite
from sugar_tpu.raster.pallas_render import gather_dup as jgather_dup
from sugar_tpu.raster.pallas_render import pack_params as jpack
from sugar_tpu.raster.pallas_render import render_pallas
from sugar_tpu.raster.preprocess import preprocess as jpreprocess
from sugar_tpu_torch.raster.api import rasterize_gaussians
from sugar_tpu_torch.raster.common import from_camera
from sugar_tpu_torch.raster.twopass import render_twopass
from sugar_tpu_torch.scripts import bench
from sugar_tpu_torch.scripts import microbench_gather as mg
from sugar_tpu_torch.scripts import microbench_prims as mp
from sugar_tpu_torch.scripts import microbench_sort as ms
from sugar_tpu_torch.scripts import profile_raster as pr
from sugar_tpu_torch.scripts import profile_trained as pt

torch.set_num_threads(2)

N_SMALL = 4096
HW = 64
TILE_CAP = 16
DENSE_CAPACITY = 10240  # the script's 2.56 x n
DENSE_K_MAX = 2048
FUSED_CAPACITY = 16384
FUSED_K_MAX = {"trained": 2304, "random": 1024}


def jax_settings():
    return jfrom_camera(jmake_camera(R=np.eye(3), T=np.zeros(3), fov_x=1.2, fov_y=1.2,
                                     height=HW, width=HW))


def port_inputs(arrays):
    return [torch.tensor(x) for x in arrays], from_camera(bench.bench_camera(HW, HW, "cpu"))


def jax_prep(arrays, st):
    m, s, q, o, c = (jnp.asarray(x) for x in arrays)
    return jpreprocess(m, o, st, scales=s, quaternions=q, colors=c)


def assert_close(name, t, j):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (name, t.shape, j.shape)
    if np.issubdtype(j.dtype, np.integer) or j.dtype == bool:
        np.testing.assert_array_equal(t, j, err_msg=name)
    else:
        scale = float(np.max(np.abs(j))) if j.size else 1.0
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5 * scale, err_msg=name)


_raster = {}


def raster_pair():
    """profile_raster's stages in both packages on bench.py's random scene
    (the JAX side as scripts/profile_raster.py calls them)."""
    if not _raster:
        arrays = bench._scene_random(N_SMALL, np.random.default_rng(0))
        st = jax_settings()
        n = N_SMALL
        with pltpu.force_tpu_interpret_mode():
            prep = jax_prep(arrays, st)
            b = jdense(prep, st, TILE_CAP, capacity=DENSE_CAPACITY)
            d = b.sorted_gauss.shape[0]
            d_pad = ((d + C_CHUNK - 1) // C_CHUNK) * C_CHUNK + C_CHUNK
            gid = jnp.concatenate([b.sorted_gauss, jnp.full((d_pad - d,), n, jnp.int32)])
            cnt = jnp.minimum(prep.tiles_touched, TILE_CAP).astype(jnp.int32)
            packed = jpack(prep.mean2d, prep.conic, prep.opacity, prep.color)
            dup = jnp.pad(jgather_dup(packed, gid, cnt, b.num_rendered <= d, n, 9, TILE_CAP),
                          ((0, ROWS - 9), (0, 0)))
            max_chunks = max(1, DENSE_K_MAX // 256)
            shape_info = (st.tiles_x, st.tiles_x * st.tiles_y, 3, max_chunks)
            comp = jtile_composite(shape_info, b.tile_start,
                                   jnp.minimum(b.tile_count, max_chunks * 256), dup, st.bg)
            twopass = render_pallas(prep, b, st, max_per_tile=DENSE_K_MAX)
            jax.block_until_ready((comp, twopass))
        args, settings = port_inputs(arrays)
        ours = pr.stages(args, settings, TILE_CAP, DENSE_CAPACITY, DENSE_K_MAX)
        with torch.no_grad():
            ours["twopass"] = render_twopass(ours["prep"], ours["binning"], settings,
                                             max_per_tile=DENSE_K_MAX)["image"]
            ours["one_call"] = rasterize_gaussians(
                args[0], args[3], settings, scales=args[1], quaternions=args[2],
                colors=args[4], mode="pallas_twopass", tile_cap=TILE_CAP,
                dup_capacity=DENSE_CAPACITY, k_max=DENSE_K_MAX)["image"]
        _raster.update(jax=dict(prep=prep, binning=b, gid=gid, dup=dup, comp=comp,
                                twopass=twopass["image"]), port=ours)
    return _raster


PREP_FIELDS = ["mean2d", "depth", "conic", "opacity", "color", "radius", "rect_min", "rect_max",
               "tiles_touched"]


@pytest.mark.parametrize("field", PREP_FIELDS)
def test_profile_raster_preprocess_matches_jax(field):
    s = raster_pair()
    assert_close(field, getattr(s["port"]["prep"], field), getattr(s["jax"]["prep"], field))


def test_profile_raster_dense_binning_matches_jax():
    s = raster_pair()
    jb, tb = s["jax"]["binning"], s["port"]["binning"]
    for f in ("sorted_gauss", "sorted_tile", "tile_start", "tile_count", "num_rendered",
              "overflow"):
        assert_close(f, getattr(tb, f), getattr(jb, f))
    assert int(tb.num_rendered) <= DENSE_CAPACITY and int(tb.overflow) == 0
    assert int(tb.tile_count.max()) > 256  # a tile walks several chunks


def test_profile_raster_gather_and_composite_match_jax():
    s = raster_pair()
    j, t = s["jax"], s["port"]
    assert_close("gid", t["gid"], j["gid"])
    assert_close("dup", t["dup"], j["dup"])
    jimg, jt, jn = j["comp"]
    assert_close("img", t["img"], jimg)
    assert_close("final_T", t["final_t"], jt)
    assert_close("n_contrib", t["n_contrib"], jn)
    np.testing.assert_allclose(t["twopass"].numpy(), np.asarray(j["twopass"]), atol=1e-5, rtol=0)


def test_profile_raster_stage_image_is_the_one_call_render():
    t = raster_pair()["port"]
    assert torch.equal(t["image"], t["one_call"])
    assert torch.equal(t["image"], t["twopass"])


_trained = {}


def trained_pair(scene):
    """profile_trained's stages in both packages (the JAX side as
    scripts/profile_trained.py calls them)."""
    if scene not in _trained:
        arrays = pt.scene_arrays(scene, N_SMALL)
        k_max = FUSED_K_MAX[scene]
        st = jax_settings()
        n = N_SMALL
        tx, nt = st.tiles_x, st.tiles_x * st.tiles_y
        max_chunks = (k_max + C_CHUNK - 1) // C_CHUNK
        with pltpu.force_tpu_interpret_mode():
            prep = jax_prep(arrays, st)
            b = jfused.bin_fused(prep, nt, tx, TILE_CAP, 4, max(n // 8, 65536), FUSED_CAPACITY)
            packed = jnp.concatenate([jpack(prep.mean2d, prep.conic, prep.opacity, prep.color),
                                      jnp.zeros((16 - 9, n), jnp.float32)], axis=0)
            dup = jgather_dup(packed, b["gid"], b["counts_culled"], b["inexact"] == 0, n, 9,
                              TILE_CAP)
            comp = jtile_composite((tx, nt, 3, max_chunks), b["tile_start"],
                                   jnp.minimum(b["tile_count"], max_chunks * C_CHUNK), dup, st.bg)
            full = jfused.render_fused(prep, st, tile_cap=TILE_CAP, capacity=FUSED_CAPACITY,
                                       max_per_tile=k_max)["image"]
            jax.block_until_ready((comp, full))
        args, settings = port_inputs(arrays)
        ours = pt.stages(args, settings, TILE_CAP, FUSED_CAPACITY, k_max)
        with torch.no_grad():
            ours["one_call"] = pt.full_render(args, settings, TILE_CAP, FUSED_CAPACITY,
                                              k_max)["image"]
        _trained[scene] = dict(jax=dict(prep=prep, bins=b, dup=dup, comp=comp, full=full),
                               port=ours)
    return _trained[scene]


@pytest.mark.parametrize("scene", ["trained", "random"])
def test_profile_trained_preprocess_matches_jax(scene):
    s = trained_pair(scene)
    for f in PREP_FIELDS:
        assert_close(f, getattr(s["port"]["prep"], f), getattr(s["jax"]["prep"], f))


@pytest.mark.parametrize("scene", ["trained", "random"])
def test_profile_trained_binning_matches_jax(scene):
    s = trained_pair(scene)
    jb, tb = s["jax"]["bins"], s["port"]["bins"]
    # The CPU route also returns the two counters that the JAX package's
    # render_fused derives from its binning.
    jb = dict(jb, cap_overflow=jnp.maximum(jb["num_rendered"] - FUSED_CAPACITY, 0),
              max_tiles_touched=jnp.max(s["jax"]["prep"].tiles_touched))
    assert set(tb) == set(jb)
    for k in jb:
        assert_close(k, tb[k], jb[k])
    assert int(tb["inexact"]) == 0 and int(tb["num_rendered"]) <= FUSED_CAPACITY


@pytest.mark.parametrize("scene", ["trained", "random"])
def test_profile_trained_gather_and_composite_match_jax(scene):
    s = trained_pair(scene)
    j, t = s["jax"], s["port"]
    assert_close("dup", t["dup"], j["dup"])
    jimg, jt, jn = j["comp"]
    assert_close("img", t["img"], jimg)
    assert_close("final_T", t["final_t"], jt)
    assert_close("n_contrib", t["n_contrib"], jn)
    np.testing.assert_allclose(float(t["n_contrib"].float().mean()), float(jnp.mean(jn)),
                               rtol=1e-6)
    np.testing.assert_allclose(t["one_call"].numpy(), np.asarray(j["full"]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("scene", ["trained", "random"])
def test_profile_trained_stage_image_is_the_one_call_render(scene):
    t = trained_pair(scene)["port"]
    assert torch.equal(t["image"], t["one_call"])
    assert int(t["bins"]["tile_count"].max()) <= FUSED_K_MAX[scene]


# --- the microbenches' operations ------------------------------------------

SMALL_N = 1000
SMALL_D = 3000


def _inputs(seed=0):
    g = np.random.default_rng(seed)
    return dict(
        gid=g.integers(0, SMALL_N, SMALL_D, dtype=np.int32),
        uniq=g.permutation(4 * SMALL_D)[:SMALL_D].astype(np.int32),  # unique keys
        perm=g.permutation(SMALL_D).astype(np.int32),
        cm=g.normal(size=(9, SMALL_N)).astype(np.float32),
        rm16=g.normal(size=(SMALL_N, 16)).astype(np.float32),
        ct=g.normal(size=(9, SMALL_D)).astype(np.float32),
        ct_rm=g.normal(size=(SMALL_D, 16)).astype(np.float32),
        rows9=g.normal(size=(9, SMALL_D)).astype(np.float32),
        keys30=g.integers(0, 2**30, SMALL_D, dtype=np.int32),
        pay=g.integers(0, 2**30, SMALL_D, dtype=np.int32),
        gmap=g.integers(0, SMALL_N, SMALL_N, dtype=np.int32),
        tile=g.integers(0, 16, SMALL_D, dtype=np.int32),
        depth=np.round(g.uniform(0.2, 8.0, SMALL_D), 1).astype(np.float32),  # with ties
        vals8=g.normal(size=(SMALL_D, 8)).astype(np.float32),
        vals16=g.normal(size=(16, SMALL_D)).astype(np.float32),
        offs=np.sort(g.integers(0, SMALL_D, SMALL_N)).astype(np.int32),
        c5=g.integers(0, 5, SMALL_N, dtype=np.int32),
        f32=g.normal(size=SMALL_N).astype(np.float32),
        rows5=g.integers(0, 2**30, (5, SMALL_D), dtype=np.int32),
    )


def _lax_sort(ops, stable, num_keys=1):
    return jax.lax.sort(tuple(jnp.asarray(x) for x in ops), dimension=0, num_keys=num_keys,
                        is_stable=stable)


def _slot(d):
    return jnp.arange(d, dtype=jnp.int32)


def _j_sort_then(c, i, cols):
    gs, perm = _lax_sort((i, _slot(i.shape[0])), False)
    return gs, (jnp.asarray(c)[:, perm] if cols else jnp.asarray(c)[perm, :])


def _j_sort_key_then_gather(k, gs, d):
    (sk,) = _lax_sort((k,), False)
    rank = sk[:d] & ((1 << 20) - 1)
    return sk[:d] >> 20, jnp.asarray(gs)[rank]


# name -> (port fn, JAX fn, input names, extra args, how to compare)
OPS = {
    "gather.col_gather": (mg.col_gather, lambda p, i: p[:, i], ("cm", "gid"), (), "exact"),
    "gather.row_gather": (mg.row_gather, lambda p, i: p[i, :], ("rm16", "gid"), (), "exact"),
    "gather.row_gather_transposed": (mg.row_gather_transposed, lambda p, i: p[i, :].T,
                                     ("rm16", "gid"), (), "exact"),
    "gather.sort_slots_col_gather": (mg.sort_slots_col_gather,
                                     lambda c, i: _j_sort_then(c, i, True), ("ct", "gid"), (),
                                     "per_key"),
    "gather.sort_slots_row_gather": (mg.sort_slots_row_gather,
                                     lambda c, i: _j_sort_then(c, i, False), ("ct_rm", "gid"), (),
                                     "per_key"),
    "gather.sort_payload_rows": (mg.sort_payload_rows,
                                 lambda c, i: _lax_sort((i,) + tuple(jnp.asarray(c)), False)[1],
                                 ("ct", "uniq"), (), "exact"),
    "gather.sort_key_payload": (mg.sort_key_payload, lambda k, p: _lax_sort((k, p), False),
                                ("uniq", "pay"), (), "exact"),
    "gather.sort_key": (mg.sort_key, lambda k: _lax_sort((k,), False)[0], ("keys30",), (),
                        "exact"),
    "gather.sort_key_then_gather": (mg.sort_key_then_gather,
                                    lambda k, gs: _j_sort_key_then_gather(k, gs, mg.D),
                                    ("keys30", "gmap"), (), "exact"),
    "gather.gather_1d": (mg.gather_1d, lambda m, r: m[r], ("gmap", "gid"), (), "exact"),
    "prims.sort_keys": (mp.sort_keys, lambda k: _lax_sort((k,), False)[0], ("keys30",), (),
                        "exact"),
    "prims.sort_key_payload_stable": (mp.sort_key_payload, lambda k, p: _lax_sort((k, p), True),
                                      ("gid", "pay"), (), "exact"),
    "prims.sort_two_keys_payload": (mp.sort_two_keys_payload,
                                    lambda a, b, p: _lax_sort((a, b, p), True, num_keys=2),
                                    ("tile", "depth", "pay"), (), "exact"),
    "prims.sort_f32_payload": (mp.sort_key_payload, lambda k, p: _lax_sort((k, p), True),
                               ("f32", "gmap"), (), "exact"),
    "prims.searchsorted_sort": (mp.searchsorted_right, lambda o, d: jnp.searchsorted(
        o, jnp.arange(d, dtype=jnp.int32), side="right", method="sort"), ("offs",), (SMALL_D,),
        "exact"),
    "prims.searchsorted_scan_unrolled": (mp.searchsorted_right, lambda o, d: jnp.searchsorted(
        o, jnp.arange(d, dtype=jnp.int32), side="right", method="scan_unrolled"), ("offs",),
        (SMALL_D,), "exact"),
    "prims.gather_rows": (mp.gather_rows, lambda x, i: x[i], ("rm16", "gid"), (), "exact"),
    "prims.gather_cols": (mp.gather_cols, lambda x, i: x[:, i], ("cm", "gid"), (), "exact"),
    "prims.take_rows": (mp.take_rows, lambda x, i: jnp.take(x, i, axis=0), ("rm16", "gid"), (),
                        "exact"),
    "prims.segment_sum_unsorted": (mp.segment_sum, lambda v, i, n: jax.ops.segment_sum(
        v, i, num_segments=n), ("vals8", "gid"), (SMALL_N,), "sum"),
    "prims.segment_sum_sorted": (lambda v, i, n: mp.segment_sum(v, torch.sort(i).values, n),
                                 lambda v, i, n: jax.ops.segment_sum(
                                     v, jnp.sort(i), num_segments=n, indices_are_sorted=True),
                                 ("vals8", "gid"), (SMALL_N,), "sum"),
    "prims.scatter_add": (mp.scatter_add, lambda v, i, n: jnp.zeros(
        (n, 8), jnp.float32).at[i].add(v), ("vals8", "gid"), (SMALL_N,), "sum"),
    "prims.cumsum_rows": (mp.cumsum_rows, lambda v: jnp.cumsum(v, axis=1), ("vals16",), (),
                          "sum"),
    "prims.cumsum_int": (mp.cumsum_int, jnp.cumsum, ("c5",), (), "exact"),
    "sort.sort_keys": (ms.sort_keys, lambda k: _lax_sort((k,), False)[0], ("keys30",), (),
                       "exact"),
    "sort.sort_key_payload": (ms.sort_key_payload, lambda k, p: _lax_sort((k, p), False),
                              ("gid", "pay"), (), "per_key"),
    "sort.sort_key_payload_stable": (ms.sort_key_payload_stable,
                                     lambda k, p: _lax_sort((k, p), True), ("gid", "pay"), (),
                                     "exact"),
    "sort.gather_cols": (ms.gather_cols, lambda r, p: r[:, p], ("rows9", "perm"), (), "exact"),
    "sort.gather_rows": (ms.gather_rows, lambda r, p: r[p, :], ("ct_rm", "perm"), (), "exact"),
    "sort.gather_1d": (ms.gather_1d, lambda r, p: r[p], ("pay", "perm"), (), "exact"),
    "sort.gather_cols_int32": (ms.gather_cols, lambda r, p: r[:, p], ("rows5", "perm"), (),
                               "exact"),
    "sort.searchsorted_left": (ms.searchsorted_left, lambda k, q: jnp.searchsorted(
        k, q, side="left", method="sort"), ("offs", "c5"), (), "exact"),
    "sort.sort_payload_rows": (ms.sort_payload_rows,
                               lambda k, r: _lax_sort((k,) + tuple(jnp.asarray(r)), False)[1],
                               ("uniq", "rows9"), (), "exact"),
    "sort.sort_pair_then_gather": (ms.sort_pair_then_gather,
                                   lambda k, r: _j_sort_then(r, k, True)[1], ("gid", "rows9"), (),
                                   "per_key_cols"),
}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _per_key(keys, cols):
    """(keys, cols) in an order fixed by the pairs alone: an unstable
    sort's payload compared as a multiset per key."""
    cols = cols if cols.ndim == 2 else cols[None]
    if cols.shape[-1] != keys.shape[0]:  # row layout (D, C)
        cols = cols.T
    order = np.lexsort(tuple(cols[::-1]) + (keys,))
    return keys[order], cols[:, order]


@pytest.mark.parametrize("name", sorted(OPS))
def test_microbench_op_matches_jax(name):
    tfn, jfn, names, extra, how = OPS[name]
    data = _inputs()
    if name == "sort.searchsorted_left":
        data["c5"] = np.arange(SMALL_N + 1, dtype=np.int32)  # the script's queries
    ours = tfn(*(torch.tensor(data[k]) for k in names), *extra)
    theirs = jfn(*(jnp.asarray(data[k]) for k in names), *extra)
    ours = [_np(x) for x in (ours if isinstance(ours, tuple) else (ours,))]
    theirs = [_np(x) for x in (theirs if isinstance(theirs, (tuple, list)) else (theirs,))]
    assert len(ours) == len(theirs)
    if how == "per_key":
        keys = _np(jnp.sort(jnp.asarray(data[names[1] if "slots" in name else names[0]])))
        np.testing.assert_array_equal(ours[0], theirs[0])
        np.testing.assert_array_equal(ours[0], keys)
        for a, b in zip(_per_key(ours[0], ours[1]), _per_key(theirs[0], theirs[1])):
            np.testing.assert_array_equal(a, b)
        return
    if how == "per_key_cols":
        keys = np.sort(data[names[0]])
        for a, b in zip(_per_key(keys, ours[0]), _per_key(keys, theirs[0])):
            np.testing.assert_array_equal(a, b)
        return
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
        if how == "exact":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * max(1.0, float(np.abs(b).max())))
