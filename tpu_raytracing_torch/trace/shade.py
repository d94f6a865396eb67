"""Shading stack: attribute rotation, texturing, LOD, bump/displacement,
Phong lighting (reference: src/Tracer.cu:15-185, 202-254, 376-469).

Port of ``tpu_raytracing/trace/shade.py`` (whole module). Everything is a
wide, branch-free op over the ray batch; the reference's per-thread
branches become masked selects. Conversions mirror CUDA: float->uchar
casts truncate toward zero, bilinear weights are computed on truncated
integer coords, and bilinear results are quantized to uint8 *before* the
trilinear mix.

Float-to-integer casts follow XLA's, which saturate: NaN gives 0 and a
value past the type's range its nearest end (``_to_i32``, ``_trunc_u8``).
torch leaves those cases undefined, and they do reach the casts: missed
rays carry NaN or infinite attributes until the hit mask is applied. Dot
products, cross products, norms and the TBN product are written out in
the reference's operation order; XLA's CPU compiler may still fuse a
multiply into the add that consumes it, so a shaded colour can differ from
the reference's by an ulp before its cast, and by one step of 255 after.
"""

from __future__ import annotations

import torch

from tpu_raytracing_torch.ops.intersect import cross as _cross
from tpu_raytracing_torch.ops.intersect import dot as _dot
from tpu_raytracing_torch.scene.types import NUM_LODS, DeviceScene, TexturePool

def _norm(a):
    return torch.sqrt((a * a).sum(dim=-1))


def _normalize(a):
    return a / _norm(a)[..., None]


def _to_i32(x):
    """XLA's float -> int32: truncate toward zero, NaN -> 0, saturate
    (through float64, which holds both ends of int32 exactly)."""
    return torch.nan_to_num(x.to(torch.float64), nan=0.0).clamp(-2.0**31, 2.0**31 - 1).to(
        torch.int32)


def _trunc_u8(x):
    """CUDA float->uchar conversion: truncate toward zero (XLA's
    saturating cast: NaN and negatives -> 0, above 255 -> 255)."""
    return torch.nan_to_num(torch.trunc(x), nan=0.0).clamp(0.0, 255.0).to(torch.uint8)


def _select(conds, vals, default):
    """``jnp.select``: the value of the first true condition."""
    out = default
    for c, v in zip(reversed(conds), reversed(vals)):
        out = torch.where(c, v, out)
    return out


def hsv_to_rgb(h, s, v):
    """HsvToRgb (src/Tracer.cu:15-40); returns float RGB in [0, 255]."""
    h = h.clamp(0.0, 1.0) * 360.0
    s = s.clamp(0.0, 1.0)
    v = v.clamp(0.0, 1.0)
    c = s * v
    x = c * (1.0 - torch.abs(torch.remainder(_to_i32(h), 120).to(torch.float32) / 60.0 - 1.0))
    m = v - c
    zero = torch.zeros_like(c)
    sextant = _to_i32(h / 60.0).clamp(0, 5)
    conds = [sextant == k for k in range(5)]
    r = _select(conds, [c, x, zero, zero, x], c)
    g = _select(conds, [x, c, c, x, zero], zero)
    b = _select(conds, [zero, zero, x, c, c], x)
    return (torch.stack([r, g, b], dim=-1) + m[..., None]) * 255.0


_PERM1 = [2, 0, 1]
_PERM2 = [1, 2, 0]


def rotate_attributes(normals, uvs, rot):
    """Undo pairing rotation at shade time (src/Tracer.cu:57-82): rot 1 ->
    corners (2, 0, 1); rot 2 -> corners (1, 2, 0). normals [R, 3, 3],
    uvs [R, 3, 2], rot [R]."""
    r = rot[:, None, None]
    n = torch.where(r == 1, normals[:, _PERM1], torch.where(r == 2, normals[:, _PERM2], normals))
    u = torch.where(r == 1, uvs[:, _PERM1], torch.where(r == 2, uvs[:, _PERM2], uvs))
    return n, u


def interpolate(corner_vals, bary_u, bary_v):
    """Barycentric interpolation over [R, 3, C] corner values
    (src/Tracer.cu:42-55)."""
    w0 = (1.0 - bary_u - bary_v)[:, None]
    return (
        corner_vals[:, 0] * w0
        + corner_vals[:, 1] * bary_u[:, None]
        + corner_vals[:, 2] * bary_v[:, None]
    )


# ---------------------------------------------------------------------------
# Texture sampling from the flat pool
# ---------------------------------------------------------------------------


def _tex_table(pool: TexturePool, tex, lod):
    """Gather (offset, w, h) for per-ray texture/lod indices: flat index
    ``tex * NUM_LODS + lod`` into the [T, NUM_LODS] tables, both clipped."""
    num_tex = pool.offset.shape[0]
    tex_safe = tex.clamp(0, num_tex - 1).to(torch.int64)
    lod_safe = lod.clamp(0, NUM_LODS - 1).to(torch.int64)
    flat = tex_safe * NUM_LODS + lod_safe
    off = pool.offset.reshape(-1)[flat]
    w = pool.width.reshape(-1)[flat]
    h = pool.height.reshape(-1)[flat]
    return off, w, h


def _read_texel(pool: TexturePool, off, w, h, x, y):
    """Clamped integer texel read -> float4 (src/Tracer.cu:103-108)."""
    x = torch.minimum(x.clamp(min=0), (w - 1).clamp(min=0))
    y = torch.minimum(y.clamp(min=0), (h - 1).clamp(min=0))
    idx = off.clamp(min=0).to(torch.int64) + y.to(torch.int64) * w + x
    return pool.texels[idx].to(torch.float32)


def sample_point(pool: TexturePool, tex, uv, lod):
    """Nearest sample with the reference's coord mapping
    (src/Tracer.cu:110-120): coord = frac(uv) * (size-1), y flipped; missing
    mips sample magenta."""
    off, w, h = _tex_table(pool, tex, lod)
    fw = (w - 1).to(torch.float32)
    fh = (h - 1).to(torch.float32)
    frac = uv - torch.floor(uv)
    cx = frac[..., 0] * fw
    cy = frac[..., 1] * fh
    ix = _to_i32(cx)
    iy = _to_i32(h.to(torch.float32) - cy - 1.0)
    texel = _read_texel(pool, off, w, h, ix, iy)
    magenta = torch.tensor([255.0, 0.0, 255.0, 255.0], device=uv.device)
    return torch.where((off < 0)[..., None], magenta, texel)


def bilinear_sample(pool: TexturePool, tex, uv, lod):
    """BilinearSample (src/Tracer.cu:122-140) -> uint8-quantized float4."""
    off, w, h = _tex_table(pool, tex, lod)
    fw = w.to(torch.float32)
    fh = h.to(torch.float32)
    frac = uv - torch.floor(uv)
    cx = frac[..., 0] * fw - 0.5
    cy = frac[..., 1] * fh - 0.5
    cy = fh - cy  # y flip (src/Tracer.cu:125)
    ix = _to_i32(cx)
    iy = _to_i32(cy)
    dx = cx - torch.trunc(cx)
    dy = cy - torch.trunc(cy)
    s0 = _read_texel(pool, off, w, h, ix, iy)
    s1 = _read_texel(pool, off, w, h, ix + 1, iy)
    s2 = _read_texel(pool, off, w, h, ix, iy - 1)
    s3 = _read_texel(pool, off, w, h, ix + 1, iy - 1)
    w0 = ((1.0 - dx) * dy)[..., None]
    w1 = (dx * dy)[..., None]
    w2 = ((1.0 - dx) * (1.0 - dy))[..., None]
    w3 = (dx * (1.0 - dy))[..., None]
    out = s0 * w0 + s1 * w1 + s2 * w2 + s3 * w3
    return torch.trunc(out)  # uchar4 quantization


def trilinear_sample(pool: TexturePool, tex, uv, lod):
    """TrilinearSample (src/Tracer.cu:142-155): mixes two uint8-quantized
    bilinear taps."""
    max_lod = pool.max_lod[tex.clamp(0, pool.max_lod.shape[0] - 1).to(torch.int64)]
    fl = _to_i32(torch.floor(lod))
    lo = torch.minimum(fl.clamp(min=0), max_lod)
    hi = torch.minimum((fl + 1).clamp(min=0), max_lod)
    s1 = bilinear_sample(pool, tex, uv, lo)
    s2 = bilinear_sample(pool, tex, uv, hi)
    frac = (lod - torch.floor(lod))[..., None]
    return torch.trunc(s1 * (1.0 - frac) + s2 * frac)


# ---------------------------------------------------------------------------
# Ray-differential LOD
# ---------------------------------------------------------------------------


def ray_triangle_gradients(v0, v1, v2, origin, direction, t, spread):
    """Barycentrics of two rays offset by the pixel footprint
    (src/Tracer.cu:202-235)."""
    edge1 = v1 - v0
    edge2 = v2 - v0
    s = origin - v0
    q = _cross(s, edge1)

    up = torch.tensor([0.0, 1.0, 0.0], device=direction.device).expand_as(direction)
    x = _normalize(_cross(direction, up)) * (t * spread)[..., None]
    y = _normalize(_cross(direction, x)) * (t * spread)[..., None]
    hit_point = origin + direction * t[..., None]
    dirx = _normalize(hit_point + x - origin)
    diry = _normalize(hit_point + y - origin)

    def barys(d):
        hh = _cross(d, edge2)
        a = _dot(edge1, hh)
        f = 1.0 / a
        bu = f * _dot(s, hh)
        bv = f * _dot(d, q)
        return bu, bv

    bu0, bv0 = barys(dirx)
    bu1, bv1 = barys(diry)
    return bu0, bv0, bu1, bv1


def _size0(pool: TexturePool, tex):
    """[R, 2] float (w, h) of each ray's texture's mip 0."""
    _, w0, h0 = _tex_table(pool, tex, torch.zeros_like(tex))
    return torch.stack([w0.to(torch.float32), h0.to(torch.float32)], dim=-1)


def compute_lod(pool, tex, v0, v1, v2, uvs3, bary_u, bary_v, origin, direction, t, spread):
    """ComputeLOD (src/Tracer.cu:237-254): log2 of the max texel-space
    footprint, clamped to [0, max_lod]."""
    bu0, bv0, bu1, bv1 = ray_triangle_gradients(v0, v1, v2, origin, direction, t, spread)
    uvs = interpolate(uvs3, bary_u, bary_v)
    uvs_x = interpolate(uvs3, bu0, bv0)
    uvs_y = interpolate(uvs3, bu1, bv1)
    size0 = _size0(pool, tex)
    dtdx = torch.abs(uvs_x - uvs) * size0
    dtdy = torch.abs(uvs_y - uvs) * size0
    max_change = torch.maximum(_norm(dtdx), _norm(dtdy))
    max_lod = pool.max_lod[tex.clamp(0, pool.max_lod.shape[0] - 1).to(torch.int64)]
    lod = torch.log2(max_change)
    return torch.minimum(torch.maximum(lod, torch.zeros_like(lod)), max_lod.to(torch.float32))


# ---------------------------------------------------------------------------
# Bump / displacement mapping
# ---------------------------------------------------------------------------


def tangent_matrix(v0, v1, v2, uvs3):
    """TangentMatrix (src/Tracer.cu:84-101): returns rows of the TBN matrix
    such that world = rows . n_tangent_space."""
    e1 = v1 - v0
    e2 = v2 - v0
    duv1 = uvs3[:, 1] - uvs3[:, 0]
    duv2 = uvs3[:, 2] - uvs3[:, 0]
    f = 1.0 / (duv1[..., 0] * duv2[..., 1] - duv1[..., 1] * duv2[..., 0])
    normal = _normalize(_cross(e1, e2))
    tangent = _normalize(f[..., None] * (e1 * duv2[..., 1:2] - e2 * duv1[..., 1:2]))
    bitangent = _normalize(f[..., None] * (e2 * duv1[..., 0:1] - e1 * duv2[..., 0:1]))
    # Row i = (tangent[i], bitangent[i], normal[i]) — row-major transform.
    return torch.stack([tangent, bitangent, normal], dim=-1)  # [R, 3, 3]


def _tbn_apply(tbn, n):
    """``einsum("rij,rj->ri")`` as three products summed in order."""
    return tbn[..., 0] * n[:, None, 0] + tbn[..., 1] * n[:, None, 1] + tbn[..., 2] * n[:, None, 2]


def bump_to_normal(pool, tex, tbn, uv, lod):
    """Bump2Normal (src/Tracer.cu:157-185): finite-difference height
    gradients -> tangent-space normal -> world."""
    texel_step = torch.pow(2.0, lod)
    step = texel_step[..., None] / _size0(pool, tex)
    zero = torch.zeros_like(lod)
    a = trilinear_sample(pool, tex, uv - step * 0.5, lod)[..., 0]
    b = trilinear_sample(pool, tex, uv + torch.stack([step[..., 0] * 0.5, zero], -1), lod)[..., 0]
    c = trilinear_sample(pool, tex, uv + torch.stack([zero, step[..., 1] * 0.5], -1), lod)[..., 0]
    gx = b - a
    gy = c - a
    d = 4.0
    denom = texel_step * 256.0
    px = d * gx / denom
    py = d * gy / denom
    one = torch.ones_like(px)
    zero = torch.zeros_like(px)
    n = _normalize(_cross(torch.stack([one, zero, px], -1), torch.stack([zero, one, py], -1)))
    return _normalize(_tbn_apply(tbn, n))


# ---------------------------------------------------------------------------
# Phong ambient shader
# ---------------------------------------------------------------------------

LIGHT_COLOUR_RGB = (1.0, 0.9, 0.8)


def light_colour(device=None) -> torch.Tensor:
    return torch.tensor(LIGHT_COLOUR_RGB, dtype=torch.float32, device=device)


def ambient_shader(
    scene: DeviceScene,
    origin,
    direction,
    t,
    bary_u,
    bary_v,
    normals3,
    uvs3,
    tri_v0,
    tri_v1,
    tri_v2,
    mat_ambient,
    mat_diffuse,
    mat_specular,
    mat_specular_exp,
    mat_texture,
    mat_bump,
    mat_disp,
    spread,
    use_textures: bool,
    use_shadows: bool,
    use_bump: bool,
    shadow_hit=None,
):
    """AmbientShader (src/Tracer.cu:376-469) over a ray batch.

    All per-ray material fields are pre-gathered; the shadow trace (a second
    full traversal in the reference, src/Tracer.cu:446-462) is run by the
    caller and passed in as ``shadow_hit``.
    """
    pool = scene.textures
    light_pos = scene.light
    lc = light_colour(origin.device)
    hit_pos = origin + direction * t[..., None]
    normal = interpolate(normals3, bary_u, bary_v)

    if use_bump:
        tbn = tangent_matrix(tri_v0, tri_v1, tri_v2, uvs3)
        uvs = interpolate(uvs3, bary_u, bary_v)
        # Displacement map: normal straight from the texture (tangent space).
        disp_lod = compute_lod(
            pool, mat_disp, tri_v0, tri_v1, tri_v2, uvs3, bary_u, bary_v,
            origin, direction, t, spread,
        )
        disp_smp = trilinear_sample(pool, mat_disp, uvs, disp_lod)[..., 0:3] / 255.0
        disp_n = _normalize(_tbn_apply(tbn, _normalize(disp_smp * 2.0 - 1.0)))
        # Bump map: height-gradient normal.
        bump_lod = compute_lod(
            pool, mat_bump, tri_v0, tri_v1, tri_v2, uvs3, bary_u, bary_v,
            origin, direction, t, spread,
        )
        bump_n = bump_to_normal(pool, mat_bump, tbn, uvs, bump_lod)
        normal = torch.where(
            (mat_disp != -1)[..., None],
            disp_n,
            torch.where((mat_bump != -1)[..., None], bump_n, normal),
        )

    light_dir = _normalize(light_pos - hit_pos)
    ambient = 0.2 * lc
    ndotl = torch.clamp(_dot(normal, light_dir), min=0.0)
    diffuse = ndotl[..., None] * lc

    def reflect(i, n):
        return i - 2.0 * n * _dot(n, i)[..., None]

    spec_base = torch.clamp(_dot(-direction, reflect(-light_dir, normal)), min=0.0)
    specular = torch.pow(spec_base, mat_specular_exp)[..., None] * lc

    object_diffuse = mat_diffuse
    if use_textures:
        lod = compute_lod(
            pool, mat_texture, tri_v0, tri_v1, tri_v2, uvs3, bary_u, bary_v,
            origin, direction, t, spread,
        )
        uvs = interpolate(uvs3, bary_u, bary_v)
        smp = bilinear_sample(pool, mat_texture, uvs, _to_i32(torch.floor(lod)))
        object_diffuse = torch.where(
            (mat_texture != -1)[..., None], smp[..., 0:3] / 255.0, object_diffuse
        )

    if use_shadows and shadow_hit is not None:
        diffuse = torch.where(shadow_hit[..., None], 0.0, diffuse)
        specular = torch.where(shadow_hit[..., None], 0.0, specular)

    colour = diffuse * object_diffuse + ambient * mat_ambient + specular * mat_specular
    colour = colour.clamp(0.0, 1.0)
    return colour * 255.0
