"""Per-Gaussian preprocessing: projection, EWA cov2D, conic, radius, tiles.

Port of ``sugar_tpu/raster/preprocess.py`` (itself a vectorized recast of
the CUDA ``preprocessCUDA`` kernel, forward.cu:160-258). Plain torch ops on
the (N, ...) parameter tensors, differentiable end to end; the covariance
math stays in structure-of-arrays channels, as in the JAX package. Where
the JAX package takes ``jnp.maximum``/``jnp.clip`` on a differentiable
value, the port takes ``torch.maximum``/``torch.minimum`` with tensor
operands, which share a tie's gradient as JAX does.

Dead/culled Gaussians are signalled by ``tiles_touched == 0`` rather than
by compaction, keeping shapes fixed.

``preprocess_fields`` starts from the model's fields: the opacity logit,
SH DC and rest, and either the raw log scales and quaternions or (the
refined model's mesh-bound Gaussians) the built scales and unit
quaternions. It takes one of two routes:

- on a CUDA device, the hand-written kernels of ``csrc/preprocess.cu``,
  which apply the activations, evaluate SH and project in one pass and
  read nothing to the host: ``preprocess_fields_cuda`` (one launch) for a
  render that needs no gradient, ``PreprocessFields`` for one that does
  (that launch, and one launch of ``preprocess_fields_bwd_cuda`` in the
  backward). A CUDA tensor never takes the torch ops.
- ``preprocess_fields_plain`` on every CPU tensor: the activations and SH
  concat, then ``preprocess``, differentiable. It is the forward kernel's
  plain version, and its autograd VJP (``preprocess_fields_bwd_plain``)
  the backward kernel's.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from sugar_tpu_torch import native
from sugar_tpu_torch.core import sh as sh_lib
from sugar_tpu_torch.core.quaternions import normalize as quat_normalize
from sugar_tpu_torch.raster import common as rc
from sugar_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class Preprocessed:
    """Per-Gaussian screen-space quantities (all shape (N, ...))."""

    mean2d: torch.Tensor  # (N, 2) pixel coords (ndc2Pix convention)
    depth: torch.Tensor  # (N,) view-space z
    conic: torch.Tensor  # (N, 3) inverse cov2D (a, b, c)
    opacity: torch.Tensor  # (N,)
    color: torch.Tensor  # (N, C) features to composite
    radius: torch.Tensor  # (N,) int32 pixel radius (0 = culled)
    rect_min: torch.Tensor  # (N, 2) int32 tile rect (x, y), inclusive
    rect_max: torch.Tensor  # (N, 2) int32 tile rect (x, y), exclusive
    tiles_touched: torch.Tensor  # (N,) int32


def _cov3d_channels(
    scales: torch.Tensor, quaternions: torch.Tensor, scale_modifier: float = 1.0
) -> tuple:
    """(N,3) scales + (N,4) unit quats -> 6 (N,) covariance channels
    (c00, c01, c02, c11, c12, c22) of Sigma = R diag(s^2) R^T
    (forward.cu:118-152). No (N,3,3) tensor is formed."""
    w, x, y, z = (quaternions[..., i] for i in range(4))
    r = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    s2 = (scale_modifier * scales) ** 2  # (N, 3)
    s0, s1, s2_ = s2[..., 0], s2[..., 1], s2[..., 2]

    def sig(i, k):
        return r[i][0] * s0 * r[k][0] + r[i][1] * s1 * r[k][1] + r[i][2] * s2_ * r[k][2]

    return sig(0, 0), sig(0, 1), sig(0, 2), sig(1, 1), sig(1, 2), sig(2, 2)


def compute_cov3d(
    scales: torch.Tensor, quaternions: torch.Tensor, scale_modifier: float = 1.0
) -> torch.Tensor:
    """(N,3) scales + (N,4) unit quats -> (N,3,3) world covariance."""
    c00, c01, c02, c11, c12, c22 = _cov3d_channels(scales, quaternions, scale_modifier)
    row0 = torch.stack([c00, c01, c02], dim=-1)
    row1 = torch.stack([c01, c11, c12], dim=-1)
    row2 = torch.stack([c02, c12, c22], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def compute_cov2d(
    means3d: torch.Tensor,
    cov3d,
    viewmatrix: torch.Tensor,
    focal_x: float,
    focal_y: float,
    tanfovx: float,
    tanfovy: float,
) -> torch.Tensor:
    """EWA projection of 3D covariance to 2D screen space (forward.cu:74-113).

    ``cov3d`` is an (N,3,3) tensor or a 6-tuple of (N,) channels. Returns
    (N, 3) packed (cov_xx, cov_xy, cov_yy) with the +0.3 low-pass added.
    """
    W = viewmatrix[:3, :3]
    t = means3d @ W.T + viewmatrix[:3, 3]
    # A 1/z at z ~ 0 on a culled Gaussian would poison gradients even under
    # masking: substitute a safe depth before any division.
    tz = torch.where(t[..., 2] > rc.Z_CULL, t[..., 2], 1.0)
    limx = rc.FOV_CLAMP * tanfovx
    limy = rc.FOV_CLAMP * tanfovy
    tx = rc.clip(t[..., 0] / tz, -limx, limx) * tz
    ty = rc.clip(t[..., 1] / tz, -limy, limy) * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    # J rows: d(pix)/d(cam xyz), third row dropped (forward.cu:89-93).
    j00 = focal_x * inv_z
    j02 = -focal_x * tx * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * inv_z2

    # M = J @ W (2x3); cov2d = M @ cov3d @ M^T, in (N,) channels.
    m0 = [j00 * W[0, k] + j02 * W[2, k] for k in range(3)]
    m1 = [j11 * W[1, k] + j12 * W[2, k] for k in range(3)]
    if isinstance(cov3d, tuple):
        s00, s01, s02, s11, s12, s22 = cov3d
    else:
        s = cov3d  # (N, 3, 3) symmetric
        s00, s01, s02 = s[..., 0, 0], s[..., 0, 1], s[..., 0, 2]
        s11, s12, s22 = s[..., 1, 1], s[..., 1, 2], s[..., 2, 2]

    def quad(a, b):
        # a^T Sigma b for 3-channel lists a, b.
        return (
            a[0] * (s00 * b[0] + s01 * b[1] + s02 * b[2])
            + a[1] * (s01 * b[0] + s11 * b[1] + s12 * b[2])
            + a[2] * (s02 * b[0] + s12 * b[1] + s22 * b[2])
        )

    cxx = quad(m0, m0) + rc.LOWPASS
    cyy = quad(m1, m1) + rc.LOWPASS
    cxy = quad(m0, m1)
    return torch.stack([cxx, cxy, cyy], dim=-1)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _tile_index(x: torch.Tensor, hi: int) -> torch.Tensor:
    """int32(x) truncated toward zero, clipped to [0, hi].

    The float is bounded first, so infinities saturate and NaN maps to 0 as
    XLA's float->int conversion does; a bare ``.to(torch.int32)`` of an
    out-of-range float is undefined. Finite values give the same result as
    truncating first and clipping after.
    """
    x = torch.clamp(torch.nan_to_num(x, nan=0.0), -1.0, hi + 1.0)
    return torch.clamp(x.to(torch.int32), 0, hi)


@profiling.spanned("raster.preprocess")
def preprocess(
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    settings: rc.RasterSettings,
    scales: torch.Tensor | None = None,
    quaternions: torch.Tensor | None = None,
    cov3d: torch.Tensor | None = None,
    colors: torch.Tensor | None = None,
    shs: torch.Tensor | None = None,
    alive_mask: torch.Tensor | None = None,
    ndc_offset: torch.Tensor | None = None,
) -> Preprocessed:
    """Vectorized preprocess for all N Gaussians.

    Either (scales, quaternions) or precomputed ``cov3d`` must be given;
    either ``colors`` (N, C) or ``shs`` (N, C, K). ``alive_mask`` force-culls
    padded/dead slots. ``ndc_offset`` (N, 2) is added to the NDC means; it
    is zero in value and exists for its gradient (the densifier's
    screen-space statistic). While a profiler collects it counts 0 under
    ``raster.preprocess_kernel`` (the kernel route counts 1).
    """
    profiling.count("raster.preprocess_kernel", 0)
    n = means3d.shape[0]
    if cov3d is None:
        cov3d = _cov3d_channels(scales, quaternions, settings.scale_modifier)
    if colors is None:
        dirs = means3d - settings.campos
        dirs = dirs / torch.maximum(torch.linalg.norm(dirs, dim=-1, keepdim=True), _f32(1e-12, dirs))
        colors = sh_lib.sh_to_rgb(settings.sh_degree, shs, dirs)

    # Projection (forward.cu:197-200).
    depth = means3d @ settings.viewmatrix[2, :3] + settings.viewmatrix[2, 3]
    in_front = depth > rc.Z_CULL
    P = settings.projmatrix
    p_hom = means3d @ P[:, :3].T + P[:, 3]
    # NaN-grad guard for near-zero homogeneous w of culled Gaussians.
    w_safe = torch.where(in_front, p_hom[..., 3] + rc.W_EPS, 1.0)
    p_w = 1.0 / w_safe
    ndc = p_hom[..., :2] * p_w[..., None]
    if ndc_offset is not None:
        ndc = ndc + ndc_offset

    mean2d = torch.stack(
        [
            ((ndc[..., 0] + 1.0) * settings.image_width - 1.0) * 0.5,
            ((ndc[..., 1] + 1.0) * settings.image_height - 1.0) * 0.5,
        ],
        dim=-1,
    )

    cov2d = compute_cov2d(
        means3d,
        cov3d,
        settings.viewmatrix,
        settings.focal_x,
        settings.focal_y,
        settings.tanfovx,
        settings.tanfovy,
    )
    cxx, cxy, cyy = cov2d[..., 0], cov2d[..., 1], cov2d[..., 2]
    det = cxx * cyy - cxy * cxy
    det_valid = det != 0.0
    det_safe = torch.where(det_valid, det, 1.0)
    inv_det = 1.0 / det_safe
    conic = torch.stack([cyy * inv_det, -cxy * inv_det, cxx * inv_det], dim=-1)

    # Radius from eigenvalues (forward.cu:227-232).
    mid = 0.5 * (cxx + cyy)
    disc = torch.sqrt(torch.maximum(mid * mid - det, _f32(0.1, det)))
    lam_max = mid + disc
    radius_f = torch.ceil(rc.RADIUS_SIGMA * torch.sqrt(torch.maximum(lam_max, _f32(0.0, det))))

    # Tile rect (auxiliary.h:46-56); the int cast truncates toward zero.
    gx, gy = settings.tiles_x, settings.tiles_y
    rmin_x = _tile_index((mean2d[..., 0] - radius_f) / rc.TILE_X, gx)
    rmin_y = _tile_index((mean2d[..., 1] - radius_f) / rc.TILE_Y, gy)
    rmax_x = _tile_index((mean2d[..., 0] + radius_f + rc.TILE_X - 1) / rc.TILE_X, gx)
    rmax_y = _tile_index((mean2d[..., 1] + radius_f + rc.TILE_Y - 1) / rc.TILE_Y, gy)

    alive = (depth > rc.Z_CULL) & det_valid
    if alive_mask is not None:
        alive = alive & alive_mask
    tiles = (rmax_x - rmin_x) * (rmax_y - rmin_y)
    tiles = torch.where(alive, tiles, 0)
    # Radii above 2^30 px (no real camera) are clamped before the int cast.
    radius = torch.where(tiles > 0, torch.clamp(radius_f, max=2.0**30), 0.0).to(torch.int32)

    return Preprocessed(
        mean2d=mean2d,
        depth=depth,
        conic=conic,
        opacity=opacities.reshape(n),
        color=colors,
        radius=radius,
        rect_min=torch.stack([rmin_x, rmin_y], dim=-1),
        rect_max=torch.stack([rmax_x, rmax_y], dim=-1),
        tiles_touched=tiles,
    )


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def fields_need_grad(*tensors) -> bool:
    """Whether a render of these tensors (None skipped) needs its gradient:
    grad mode is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _shape_fields(log_scales, quaternions, scales, unit_quaternions):
    """(built, the scale field, the quaternion field): the raw log scales
    and quaternions, or the built scales and unit quaternions."""
    built = scales is not None or unit_quaternions is not None
    if built and (scales is None or unit_quaternions is None
                  or log_scales is not None or quaternions is not None):
        raise ValueError("give log_scales and quaternions, or scales and unit_quaternions")
    return (True, scales, unit_quaternions) if built else (False, log_scales, quaternions)


def preprocess_fields(
    xyz: torch.Tensor,
    opacity_logit: torch.Tensor,
    log_scales: torch.Tensor | None,
    quaternions: torch.Tensor | None,
    sh_dc: torch.Tensor,
    sh_rest: torch.Tensor,
    settings: rc.RasterSettings,
    alive_mask: torch.Tensor | None = None,
    colors: torch.Tensor | None = None,
    ndc_offset: torch.Tensor | None = None,
    scales: torch.Tensor | None = None,
    unit_quaternions: torch.Tensor | None = None,
) -> Preprocessed:
    """``Preprocessed`` from the model's fields: ``xyz`` (N, 3),
    ``opacity_logit`` (N,), ``log_scales`` (N, 3) and raw ``quaternions``
    (N, 4), or in their place the built ``scales`` (N, 3) and
    ``unit_quaternions`` (N, 4), ``sh_dc`` (N, 3) and ``sh_rest`` (N, 3, K
    - 1), of which the coefficients of ``settings.sh_degree`` are read;
    ``colors`` (N, C) replaces SH. On a CUDA device the kernels: for a
    render that needs no gradient ``preprocess_fields_cuda``, for one that
    does ``PreprocessFields``; on the CPU the differentiable torch ops
    (``preprocess_fields_plain``)."""
    if colors is not None:
        sh_dc = sh_rest = None  # unread under a colors override
    fields = (xyz, opacity_logit, log_scales, quaternions, sh_dc, sh_rest)
    extra = (colors, ndc_offset, scales, unit_quaternions)
    if not _on_card(xyz):
        return preprocess_fields_plain(*fields, settings, alive_mask, *extra)
    if fields_need_grad(*fields, *extra):
        return Preprocessed(*PreprocessFields.apply(settings, alive_mask, *fields, *extra))
    return preprocess_fields_cuda(*fields, settings, alive_mask, *extra)


def preprocess_fields_plain(
    xyz, opacity_logit, log_scales, quaternions, sh_dc, sh_rest, settings,
    alive_mask=None, colors=None, ndc_offset=None, scales=None, unit_quaternions=None,
) -> Preprocessed:
    """The plain version of ``preprocess_fields_cuda``: sigmoid, exp, the
    quaternion normalisation (none of the two for built scales and unit
    quaternions) and the SH concat (the ``render.setup`` span), then
    ``preprocess``. Differentiable in every field."""
    built, s, q = _shape_fields(log_scales, quaternions, scales, unit_quaternions)
    with profiling.span("render.setup"):
        opacities = torch.sigmoid(opacity_logit)
        if not built:
            s = torch.exp(s)
            q = quat_normalize(q)
        shs = None
        if colors is None:
            k = (settings.sh_degree + 1) ** 2
            shs = torch.cat([sh_dc[:, :, None], sh_rest], dim=-1)[:, :, :k]
    return preprocess(xyz, opacities, settings, scales=s, quaternions=q,
                      colors=colors, shs=shs, alive_mask=alive_mask, ndc_offset=ndc_offset)


class PreprocessFields(torch.autograd.Function):
    """``preprocess_fields`` on the card for a render that needs its
    gradient: the forward kernel (``preprocess_fields_cuda``, which counts
    the launch) and in the backward one launch of the backward kernel
    (``preprocess_fields_bwd_cuda``), which recomputes the forward from
    the fields, saved by reference. Takes the settings, the alive mask and
    the fields in ``preprocess_fields_bwd_cuda``'s gradient order; returns
    the fields of ``Preprocessed`` in order, of which depth, radius, the
    rects and tiles_touched carry no gradient."""

    @staticmethod
    def forward(ctx, settings, alive_mask, *fields):
        xyz, opacity_logit, log_scales, quaternions, sh_dc, sh_rest, *extra = fields
        prep = preprocess_fields_cuda(xyz, opacity_logit, log_scales, quaternions, sh_dc,
                                      sh_rest, settings, alive_mask, *extra)
        ctx.save_for_backward(*fields)
        ctx.settings = settings
        ctx.mark_non_differentiable(prep.depth, prep.radius, prep.rect_min, prep.rect_max,
                                    prep.tiles_touched)
        return tuple(getattr(prep, f.name) for f in dataclasses.fields(Preprocessed))

    @staticmethod
    def backward(ctx, g_mean2d, _g_depth, g_conic, g_opacity, g_color, *_g_ints):
        xyz, opacity_logit, log_scales, quaternions, sh_dc, sh_rest, *extra = ctx.saved_tensors
        return (None, None) + preprocess_fields_bwd_cuda(
            g_mean2d, g_conic, g_opacity, g_color, xyz, opacity_logit, log_scales, quaternions,
            sh_dc, sh_rest, ctx.settings, None, *extra)


# The gradients the backward returns, in order: of every field
# preprocess_fields takes.
GRAD_FIELDS = ("xyz", "opacity_logit", "log_scales", "quaternions", "sh_dc", "sh_rest", "colors",
               "ndc_offset", "scales", "unit_quaternions")


def preprocess_fields_bwd_plain(
    g_mean2d, g_conic, g_opacity, g_color,
    xyz, opacity_logit, log_scales, quaternions, sh_dc, sh_rest, settings,
    alive_mask=None, colors=None, ndc_offset=None, scales=None, unit_quaternions=None,
) -> tuple:
    """The plain version of ``preprocess_fields_bwd_cuda``: the autograd
    VJP of ``preprocess_fields_plain`` at the cotangents of mean2d, conic,
    opacity and color. Same arguments and results."""
    if colors is not None:
        sh_dc = sh_rest = None
    fields = (xyz, opacity_logit, log_scales, quaternions, sh_dc, sh_rest, colors, ndc_offset,
              scales, unit_quaternions)
    leaves = [None if f is None else f.detach().requires_grad_(True) for f in fields]
    with torch.enable_grad():
        prep = preprocess_fields_plain(*leaves[:6], settings, alive_mask, *leaves[6:])
        got = iter(torch.autograd.grad(
            (prep.mean2d, prep.conic, prep.opacity, prep.color),
            [f for f in leaves if f is not None], (g_mean2d, g_conic, g_opacity, g_color),
            allow_unused=True))
    return tuple(None if f is None else next(got) for f in leaves)


def _kernel_fn(name: str, argtypes: list):
    fn = getattr(native.load("preprocess"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_VP, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = ([_VP] * 6 + [_I32] * 3 + [_VP, _I32, _VP, _VP, _VP, _VP, _VP, ctypes.c_longlong]
             + [_I32] * 4 + [_F32] * 5 + [_VP] * 9 + [_VP])
_BWD_ARGS = ([_VP] * 6 + [_I32] * 3 + [_VP] * 3 + [ctypes.c_longlong] + [_I32] * 2
             + [_F32] * 5 + [_VP] * 4 + [_VP] * 7 + [_VP])


def _checked(name: str, x: torch.Tensor, shape: tuple, dtype, dev) -> torch.Tensor:
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"{name} must be {dtype} {shape} on {dev}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return x.contiguous()


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def _kernel_fields(xyz, opacity_logit, log_scales, quaternions, sh_dc, sh_rest, settings,
                   colors, scales, unit_quaternions):
    """The fields both kernels read, checked and made contiguous: (built,
    xyz, opacity_logit, scale field, quaternion field, sh_dc, sh_rest, rest
    coefficients, the camera's view, proj and campos); sh_dc and sh_rest
    None under a colors override."""
    n, dev = xyz.shape[0], xyz.device
    built, s, q = _shape_fields(log_scales, quaternions, scales, unit_quaternions)
    if not 0 <= settings.sh_degree <= 4:
        raise ValueError(f"SH degree {settings.sh_degree} is outside 0..4")
    f32 = torch.float32
    rest = 0
    if colors is None:
        rest = sh_rest.shape[-1]
        need = (settings.sh_degree + 1) ** 2 - 1
        if need > rest:
            raise ValueError(f"SH degree {settings.sh_degree} needs {need} rest coefficients, "
                             f"sh_rest has {tuple(sh_rest.shape)}")
        sh_dc = _checked("sh_dc", sh_dc, (n, 3), f32, dev)
        sh_rest = _checked("sh_rest", sh_rest, (n, 3, rest), f32, dev)
    else:
        sh_dc = sh_rest = None
    return (built, _checked("xyz", xyz, (n, 3), f32, dev),
            _checked("opacity_logit", opacity_logit, (n,), f32, dev),
            _checked("scales" if built else "log_scales", s, (n, 3), f32, dev),
            _checked("unit_quaternions" if built else "quaternions", q, (n, 4), f32, dev),
            sh_dc, sh_rest, rest,
            _checked("viewmatrix", settings.viewmatrix, (4, 4), f32, dev),
            _checked("projmatrix", settings.projmatrix, (4, 4), f32, dev),
            _checked("campos", settings.campos, (3,), f32, dev))


def _camera_args(settings: rc.RasterSettings) -> tuple:
    return (settings.focal_x, settings.focal_y, rc.FOV_CLAMP * settings.tanfovx,
            rc.FOV_CLAMP * settings.tanfovy, settings.scale_modifier)


def preprocess_fields_cuda(
    xyz, opacity_logit, log_scales, quaternions, sh_dc, sh_rest, settings,
    alive_mask=None, colors=None, ndc_offset=None, scales=None, unit_quaternions=None,
) -> Preprocessed:
    """The forward kernel of ``preprocess_fields``: one launch of
    ``csrc/preprocess.cu`` on the current stream, inside a
    ``raster.preprocess`` span. Reads nothing to the host and copies
    nothing to the card (the camera is read where it lies). It launches the
    forward alone and records no backward: a render that needs a gradient
    goes through ``PreprocessFields``, and this raises when called for one
    outside it. ``preprocess_fields_cuda.launches`` counts successful
    calls; while a profiler collects it counts 1 under
    ``raster.preprocess_kernel``."""
    n, dev, f32 = xyz.shape[0], xyz.device, torch.float32
    built, xyz, opacity_logit, s, q, sh_dc, sh_rest, rest, view, proj, campos = _kernel_fields(
        xyz, opacity_logit, log_scales, quaternions, sh_dc, sh_rest, settings, colors, scales,
        unit_quaternions)
    if fields_need_grad(xyz, opacity_logit, s, q, sh_dc, sh_rest, colors, ndc_offset):
        raise ValueError("preprocess_fields_cuda records no backward; a render that needs a "
                         "gradient goes through PreprocessFields")
    ch = 3
    if colors is not None:
        ch = colors.shape[-1]
        colors = _checked("colors", colors, (n, ch), f32, dev)
    if alive_mask is not None:
        alive_mask = _checked("alive_mask", alive_mask, (n,), torch.bool, dev)
    if ndc_offset is not None:
        ndc_offset = _checked("ndc_offset", ndc_offset, (n, 2), f32, dev)

    with profiling.span("raster.preprocess"):
        prep = Preprocessed(
            mean2d=torch.empty((n, 2), dtype=f32, device=dev),
            depth=torch.empty((n,), dtype=f32, device=dev),
            conic=torch.empty((n, 3), dtype=f32, device=dev),
            opacity=torch.empty((n,), dtype=f32, device=dev),
            color=torch.empty((n, ch), dtype=f32, device=dev),
            radius=torch.empty((n,), dtype=torch.int32, device=dev),
            rect_min=torch.empty((n, 2), dtype=torch.int32, device=dev),
            rect_max=torch.empty((n, 2), dtype=torch.int32, device=dev),
            tiles_touched=torch.empty((n,), dtype=torch.int32, device=dev),
        )
        with torch.cuda.device(dev):
            err = _kernel_fn("sugar_preprocess_fields", _FWD_ARGS)(
                xyz.data_ptr(), opacity_logit.data_ptr(), s.data_ptr(), q.data_ptr(),
                _ptr(sh_dc), _ptr(sh_rest), rest, settings.sh_degree, int(built),
                _ptr(colors), ch, _ptr(alive_mask), _ptr(ndc_offset), view.data_ptr(),
                proj.data_ptr(), campos.data_ptr(), n, settings.image_width,
                settings.image_height, settings.tiles_x, settings.tiles_y,
                *_camera_args(settings),
                *(getattr(prep, f.name).data_ptr() for f in dataclasses.fields(Preprocessed)),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"preprocess kernel launch failed: CUDA error {err}")
        preprocess_fields_cuda.launches += 1
        profiling.count("raster.preprocess_kernel", 1)
    return prep


preprocess_fields_cuda.launches = 0


@profiling.spanned("raster.preprocess_bwd")
def preprocess_fields_bwd_cuda(
    g_mean2d, g_conic, g_opacity, g_color,
    xyz, opacity_logit, log_scales, quaternions, sh_dc, sh_rest, settings,
    alive_mask=None, colors=None, ndc_offset=None, scales=None, unit_quaternions=None,
) -> tuple:
    """The backward kernel of ``preprocess_fields``: one launch of
    ``csrc/preprocess.cu``'s backward on the current stream, which
    recomputes the forward from the fields (the forward's arguments, whose
    values of ``alive_mask``, ``colors`` and ``ndc_offset`` it does not
    read) and takes the VJP at the cotangents of mean2d (N, 2), conic (N,
    3), opacity (N,) and color (N, C). Returns the gradients of (xyz,
    opacity_logit, log_scales, quaternions, sh_dc, sh_rest, colors,
    ndc_offset, scales, unit_quaternions) (``GRAD_FIELDS``), None for a
    field not given and for sh_dc and sh_rest under a colors override;
    sh_rest's is zero beyond the active degree and a colors override's is
    its cotangent.
    ``preprocess_fields_bwd_cuda.launches`` counts successful calls."""
    n, dev, f32 = xyz.shape[0], xyz.device, torch.float32
    built, xyz, opacity_logit, s, q, sh_dc, sh_rest, rest, view, proj, campos = _kernel_fields(
        xyz, opacity_logit, log_scales, quaternions, sh_dc, sh_rest, settings, colors, scales,
        unit_quaternions)
    g_mean2d = _checked("g_mean2d", g_mean2d, (n, 2), f32, dev)
    g_conic = _checked("g_conic", g_conic, (n, 3), f32, dev)
    g_opacity = _checked("g_opacity", g_opacity, (n,), f32, dev)
    g_sh = None
    if sh_dc is not None:
        g_sh = _checked("g_color", g_color, (n, 3), f32, dev)

    def empty(*shape):
        return torch.empty(shape, dtype=f32, device=dev)

    g_xyz, g_ol, g_s, g_q = empty(n, 3), empty(n), empty(n, 3), empty(n, 4)
    g_dc = g_rest = g_ndc = None
    if sh_dc is not None:
        g_dc, g_rest = empty(n, 3), empty(n, 3, rest)
    if ndc_offset is not None:
        g_ndc = empty(n, 2)
    with torch.cuda.device(dev):
        err = _kernel_fn("sugar_preprocess_fields_bwd", _BWD_ARGS)(
            xyz.data_ptr(), opacity_logit.data_ptr(), s.data_ptr(), q.data_ptr(), _ptr(sh_dc),
            _ptr(sh_rest), rest, settings.sh_degree, int(built), view.data_ptr(),
            proj.data_ptr(), campos.data_ptr(), n, settings.image_width, settings.image_height,
            *_camera_args(settings), g_mean2d.data_ptr(), g_conic.data_ptr(),
            g_opacity.data_ptr(), _ptr(g_sh), g_xyz.data_ptr(), g_ol.data_ptr(),
            g_s.data_ptr(), g_q.data_ptr(), _ptr(g_dc), _ptr(g_rest), _ptr(g_ndc),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"preprocess backward kernel launch failed: CUDA error {err}")
    preprocess_fields_bwd_cuda.launches += 1
    shape = (None, None, g_s, g_q) if built else (g_s, g_q, None, None)
    return (g_xyz, g_ol, *shape[:2], g_dc, g_rest, None if colors is None else g_color, g_ndc,
            *shape[2:])


preprocess_fields_bwd_cuda.launches = 0
