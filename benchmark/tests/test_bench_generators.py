"""The inputs are a function of the seed: the same seed gives the same
tensors, another seed others; the mesh and its adjacency are sound."""

import torch

from benchmark import scenes
from benchmark.models import free_gaussians, refined_mesh
from benchmark.run import cell_parts, load_spec

from conftest import SMALL


def cfg_of(cell):
    _, cfg, _, _ = cell_parts(load_spec(), cell)
    return dict(cfg, **SMALL[cfg["name"]])


def flat(inp):
    out = []
    for k in sorted(inp):
        v = inp[k]
        if isinstance(v, dict):
            out += [v[a] for a in sorted(v)]
        elif isinstance(v, torch.Tensor):
            out.append(v)
    return out


def test_free_gaussians_same_seed_same_inputs():
    cfg = cfg_of("train_vanilla_7k")
    big = 2**40 + 12345
    a, b = free_gaussians.build(cfg, big, "cpu"), free_gaussians.build(cfg, big, "cpu")
    c = free_gaussians.build(cfg, big + 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))
    assert not torch.equal(a["params"]["log_scales"], c["params"]["log_scales"])
    # The targets are photographs of the scene's surface, the same for
    # every seed.
    assert torch.equal(a["targets"], c["targets"])
    assert int(a["alive"].sum()) == cfg["alive"]


def test_refined_mesh_same_seed_same_inputs():
    cfg = cfg_of("train_refine_highpoly")
    a, b = refined_mesh.build(cfg, 7, "cpu"), refined_mesh.build(cfg, 7, "cpu")
    c = refined_mesh.build(cfg, 8, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))
    assert not torch.equal(a["opacity_logit"], c["opacity_logit"])
    assert torch.equal(a["vertices"], c["vertices"])


def test_targets_show_the_surface():
    cfg = cfg_of("train_vanilla_7k")
    t = free_gaussians.build(cfg, 1, "cpu")["targets"]
    covered = (t.sum(-1) > 0).float().mean(dim=(1, 2))
    assert bool(((covered > 0.05) & (covered < 0.5)).all())
    assert float(t.max()) <= 1.0 and float(t.min()) >= 0.0


def test_latlong_mesh_is_closed():
    cfg = cfg_of("train_refine_highpoly")
    v, f = scenes.latlong_mesh(cfg, "cpu")
    assert v.shape[0] == cfg["rings"] * cfg["segments"] + 2
    assert f.shape[0] == 2 * cfg["segments"] * cfg["rings"]
    pairs = scenes.face_pairs(f)
    # A closed mesh: every edge is shared by two faces.
    assert pairs.shape[0] * 2 == f.shape[0] * 3


def test_full_size_mesh_counts():
    _, cfg, _, _ = cell_parts(load_spec(), "train_refine_highpoly")
    assert abs(cfg["rings"] * cfg["segments"] + 2 - cfg["vertices"]) < 1000
