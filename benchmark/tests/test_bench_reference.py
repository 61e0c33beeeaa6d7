"""The reference rasterizer against a brute-force per-pixel composite of
the published algorithm, image and gradients, at a tiny size."""

import torch

from benchmark.reference import raster as rr


def scene(n=40, seed=0):
    g = torch.Generator().manual_seed(seed)
    means = torch.stack([torch.rand(n, generator=g) * 2 - 1, torch.rand(n, generator=g) * 2 - 1,
                         3 + torch.rand(n, generator=g)], -1)
    scales = 0.05 + 0.2 * torch.rand(n, 3, generator=g)
    q = torch.randn(n, 4, generator=g)
    q = q / q.norm(dim=-1, keepdim=True)
    op = 0.3 + 0.69 * torch.rand(n, generator=g)
    col = torch.rand(n, 3, generator=g)
    return means, scales, q, op, col


def view(h=40, w=56):
    return rr.look_at_view((0.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.0, 1.0, 0.0), 1.0, h, w)


def brute(sc: rr.Screen, v: rr.View, bg):
    """Every pixel against every Gaussian of its tile's rect, one pixel at a
    time, in depth order (ties by index)."""
    order = sorted(range(sc.depth.shape[0]), key=lambda i: (float(sc.depth[i].detach()), i))
    rows = []
    for y in range(v.height):
        row = []
        for x in range(v.width):
            tx, ty = x // 16, y // 16
            t = torch.ones(())
            c = torch.zeros(3)
            for i in order:
                if not bool(sc.visible[i]):
                    continue
                if not (sc.rect_min[i, 0] <= tx < sc.rect_max[i, 0]
                        and sc.rect_min[i, 1] <= ty < sc.rect_max[i, 1]):
                    continue
                dx = sc.mean2d[i, 0] - x
                dy = sc.mean2d[i, 1] - y
                a_, b_, c_ = sc.conic[i]
                power = -0.5 * (a_ * dx * dx + c_ * dy * dy) - b_ * dx * dy
                if power > 0:
                    continue
                raw = sc.opacity[i] * torch.exp(power)
                alpha = raw + (torch.clamp(raw, max=0.99) - raw).detach()
                if alpha < 1 / 255:
                    continue
                if t * (1 - alpha) < 1e-4:
                    break
                c = c + sc.color[i] * alpha * t
                t = t * (1 - alpha)
            row.append(c + t * bg)
        rows.append(torch.stack(row))
    return torch.stack(rows)


def leaves_and_screen(v):
    means, scales, q, op, col = scene()
    leaves = [x.clone().requires_grad_(True) for x in (means, scales, q, op, col)]
    cov = rr.cov_from_quaternions(leaves[1], leaves[2])
    return leaves, rr.project(leaves[0], cov, leaves[3], v, colors=leaves[4])


def test_image_and_gradients_match_brute_force():
    v = view()
    bg = torch.tensor([0.1, 0.2, 0.3])
    w = torch.rand(v.height, v.width, 3, generator=torch.Generator().manual_seed(1))

    leaves, sc = leaves_and_screen(v)
    img, groups = rr.render(sc, v, bg)
    rr.backward(sc, v, bg, groups, w)
    got = [x.grad.clone() for x in leaves]

    leaves_b, sc_b = leaves_and_screen(v)
    ref = brute(sc_b, v, bg)
    (ref * w).sum().backward()
    assert torch.allclose(img, ref.detach(), atol=1e-5)
    for g, x in zip(got, leaves_b):
        assert torch.allclose(g, x.grad, atol=1e-4 * float(x.grad.abs().max()) + 1e-7)


def test_every_slot_is_composited_when_the_group_is_cut():
    """Groups of one tile each give the image of one group of all tiles."""
    v = view()
    bg = torch.zeros(3)
    _, sc = leaves_and_screen(v)
    img, _ = rr.render(sc, v, bg)
    old = rr.GROUP_SLOTS
    try:
        rr.GROUP_SLOTS = 1
        img1, groups = rr.render(sc, v, bg)
    finally:
        rr.GROUP_SLOTS = old
    assert len(groups) > 1
    assert torch.allclose(img, img1, atol=1e-6)
