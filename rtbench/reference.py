"""The benchmark's plain reference: the animation, the camera model,
brute-force ray casting (flat, and two-level over instances), the path
tracer and the render modes' colours, in plain PyTorch and NumPy. A
scene's inputs are its kind's (``scenes/<kind>.py``), a camera's path its
own file's (``cameras/<name>.py``).

It imports nothing of the program under test (``tpu_raytracing_torch``)
and nothing of the JAX package. It works every answer out again from the
triangles, cameras and random streams that the harness hands both sides,
with no acceleration structure: every ray is tested against every
triangle (of every instance whose box its interval meets). ``dtype``
selects the precision of the ray casts (float32 for the reference,
bfloat16 for the control).

The formulas follow the program's documented semantics (the reference
renderer's ``src/Tracer.cu`` as the port describes it): Moller-Trumbore
hits, flat triangle normals, a Lambertian path tracer with next-event
estimation toward the scene's point light and cosine-weighted bounces
keyed by pixel, the sky on a miss, and the render modes' truncating
float-to-byte casts.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PRIMARY_TMIN = 1e-5
SHADOW_TMIN = 1e-3
BOUNCE_OFFSET = 1e-4
SKY_HORIZON = (1.0, 1.0, 1.0)
SKY_ZENITH = (0.5, 0.7, 1.0)
LIGHT_COLOUR = (1.0, 0.9, 0.8)
DET_EPS = 1e-9
# rays cast against every triangle at once; [RAY_BLOCK, T] per temporary
RAY_BLOCK = 32
# the two-level caster: (ray, instance) pairs cast against every object
# triangle at once, PAIR_ELEMS // T of them ([rows, T] per temporary);
# rays whose interval is slab-tested against every instance's box at once
PAIR_ELEMS = 1 << 24
INSTANCED_RAY_BLOCK = 256
# each instance's box is widened by this share of the scene's largest
# coordinate, for the rounding of the object-space tests and the slabs
BOX_PAD = 1e-5


# ---------------------------------------------------------------------------
# Scene and camera
# ---------------------------------------------------------------------------


def terrain_triangles(num_triangles: int, extent: float, height: float,
                      seed: int) -> np.ndarray:
    """The terrain kind's triangles (``scenes/terrain.py``), for the port's
    tests that build the benchmark's scene."""
    from rtbench.scenes import terrain

    return terrain.terrain_triangles(num_triangles, extent, height, seed)


def wobble(triangles: torch.Tensor, time: float, amplitude: float = 0.05) -> torch.Tensor:
    """The animation: every vertex moved by a smooth function of its own
    position and the time."""
    phase = triangles[..., 0] * 1.7 + triangles[..., 2] * 1.3
    w = torch.stack([torch.sin(phase * 2.0 + time), torch.cos(phase * 3.0 + time * 1.3),
                     torch.sin(phase * 2.5 + time * 0.7)], dim=-1)
    return triangles + amplitude * w


def flat_normals(triangles: torch.Tensor) -> torch.Tensor:
    """[T, 3] unit normals of cross(v1 - v0, v2 - v1) (0 for degenerate)."""
    n = torch.linalg.cross(triangles[:, 1] - triangles[:, 0], triangles[:, 2] - triangles[:, 1])
    length = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return n / torch.where(length == 0, 1.0, length)


def _basis(yaw: float, pitch: float):
    w = np.array([-math.sin(yaw) * math.cos(pitch), -math.sin(pitch),
                  math.cos(yaw) * math.cos(pitch)], np.float64)
    w /= np.linalg.norm(w)
    u = np.cross(w, [0.0, 1.0, 0.0])
    u /= np.linalg.norm(u)
    v = np.cross(w, u)
    v /= np.linalg.norm(v)
    return w, u, v


def camera(position, yaw: float, pitch: float, max_depth: float) -> dict:
    """A yaw/pitch camera as float32 arrays: a pixel's ray direction is
    ndc.x * u + ndc.y * v + w, normalised (v points down the image)."""
    w, u, v = _basis(yaw, pitch)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(position=f32(position), u=f32(u), v=f32(v), w=f32(w),
                max_depth=np.float32(max_depth))


def _aerial_orbit(aabb_min, aabb_max, step: int, period: int) -> dict:
    from rtbench.cameras import aerial_orbit

    return aerial_orbit.pose(aabb_min, aabb_max, step, period)


# the cameras that the port's tests read by name; the harness finds a
# traffic's camera in ``cameras/<name>.py``
CAMERAS = {"aerial_orbit": _aerial_orbit}


def primary_rays(cam: dict, width: int, height: int, pixels: torch.Tensor, device):
    """(origin, direction, tmin, tmax) of the given row-major pixels."""
    x = (pixels % width).to(torch.float32)
    y = (pixels // width).to(torch.float32)
    ndc_x = 2.0 * ((x + 0.5) / width) - 1.0
    ndc_y = 2.0 * ((y + 0.5) / height) - 1.0
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    p = ndc_x[:, None] * t(cam["u"]) + ndc_y[:, None] * t(cam["v"]) + t(cam["w"])
    d = p / torch.linalg.vector_norm(p, dim=-1, keepdim=True)
    n = pixels.shape[0]
    o = t(cam["position"]).expand(n, 3)
    return (o, d, torch.full((n,), PRIMARY_TMIN, device=device),
            torch.full((n,), float(cam["max_depth"]), device=device))


# ---------------------------------------------------------------------------
# Brute-force ray casting
# ---------------------------------------------------------------------------


class Caster:
    """Every ray against every triangle (Moller-Trumbore), in ``dtype``,
    ``RAY_BLOCK`` rays at a time."""

    def __init__(self, triangles: torch.Tensor, dtype=torch.float32):
        self.dtype = dtype
        tri = triangles.to(dtype)
        self.v0 = tri[:, 0].T.contiguous()  # [3, T]
        self.e1 = (tri[:, 1] - tri[:, 0]).T.contiguous()
        self.e2 = (tri[:, 2] - tri[:, 0]).T.contiguous()

    def _block(self, o, d, tmin, tmax, any_hit: bool, det_eps=DET_EPS):
        dt = self.dtype
        o, d = o.to(dt), d.to(dt)
        (e1x, e1y, e1z), (e2x, e2y, e2z) = self.e1, self.e2
        dx, dy, dz = (d[:, i:i + 1] for i in range(3))
        hx = dy * e2z - dz * e2y
        hy = dz * e2x - dx * e2z
        hz = dx * e2y - dy * e2x
        det = e1x * hx + e1y * hy + e1z * hz
        f = 1.0 / det
        sx = o[:, 0:1] - self.v0[0]
        sy = o[:, 1:2] - self.v0[1]
        sz = o[:, 2:3] - self.v0[2]
        u = f * (sx * hx + sy * hy + sz * hz)
        del hx, hy, hz
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        del sx, sy, sz
        v = f * (dx * qx + dy * qy + dz * qz)
        t = f * (e2x * qx + e2y * qy + e2z * qz)
        del qx, qy, qz
        ok = ((det.abs() >= det_eps) & (u >= 0) & (v >= 0) & (u + v <= 1)
              & (t >= tmin[:, None].to(dt)) & (t <= tmax[:, None].to(dt)))
        if any_hit:
            return ok.any(dim=1)
        t = torch.where(ok, t, torch.inf)
        best, idx = t.min(dim=1)
        rows = torch.arange(idx.shape[0], device=idx.device)
        return (torch.isfinite(best), best.float(), idx, u[rows, idx].float(),
                v[rows, idx].float())

    def closest(self, o, d, tmin, tmax):
        """(hit, t, triangle, u, v) per ray."""
        parts = [self._block(o[i:i + RAY_BLOCK], d[i:i + RAY_BLOCK], tmin[i:i + RAY_BLOCK],
                             tmax[i:i + RAY_BLOCK], False)
                 for i in range(0, o.shape[0], RAY_BLOCK)]
        if not parts:
            z = torch.zeros(0, device=o.device)
            return z.bool(), z, z.long(), z, z
        return tuple(torch.cat(p) for p in zip(*parts))

    def occluded(self, o, d, tmin, tmax):
        """Whether any triangle lies within [tmin, tmax] on each ray."""
        if o.shape[0] == 0:
            return torch.zeros(0, dtype=torch.bool, device=o.device)
        return torch.cat([self._block(o[i:i + RAY_BLOCK], d[i:i + RAY_BLOCK],
                                      tmin[i:i + RAY_BLOCK], tmax[i:i + RAY_BLOCK], True)
                          for i in range(0, o.shape[0], RAY_BLOCK)])


def instance_boxes(triangles: torch.Tensor, transforms: torch.Tensor):
    """(lo, hi) [I, 3]: each instance's world box, the least and greatest
    of its own transformed vertices (world <- object, [I, 3, 4]), taken a
    block of instances at a time."""
    verts = triangles.reshape(-1, 3).float()
    x = transforms.float()
    step = max(1, PAIR_ELEMS // verts.shape[0])
    lo, hi = [], []
    for i in range(0, x.shape[0], step):
        w = torch.einsum("bij,vj->bvi", x[i:i + step, :, :3], verts) + x[i:i + step, None, :, 3]
        lo.append(w.amin(dim=1))
        hi.append(w.amax(dim=1))
    return torch.cat(lo), torch.cat(hi)


class InstanceNormals:
    """The flat normal of a two-level hit id (instance x T + triangle): the
    object triangle's normal through its instance's inverse transpose,
    turned with the sign of the transform's determinant (as the normal of
    the transformed triangle turns), and normalised."""

    def __init__(self, object_normals: torch.Tensor, normal_maps: torch.Tensor):
        self.object_normals = object_normals
        self.maps = normal_maps  # [I, 3, 3]
        self.num_tris = object_normals.shape[0]

    def __getitem__(self, ids: torch.Tensor) -> torch.Tensor:
        n = torch.einsum("nij,nj->ni", self.maps[ids // self.num_tris],
                         self.object_normals[ids % self.num_tris])
        length = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
        return n / torch.where(length == 0, 1.0, length)


class InstancedCaster:
    """Rays against instances of one object-space triangle set: every ray
    mapped into each instance's object space by the inverse of its
    transform (world <- object, [I, 3, 4]) and tested against every
    triangle there with ``Caster``'s Moller-Trumbore. The direction is not
    normalised, so t stays a distance along the world ray, and u, v are
    the world triangle's. The determinant bound is the world test's:
    ``DET_EPS`` over |det A| (the world determinant is det A times the
    object one). A hit id is instance x T + triangle; ``normals`` maps ids
    to normals. No world triangle is made.

    With ``skip``, an instance is left out of a ray's tests only where the
    ray's interval misses the instance's box (``instance_boxes``, widened
    by ``BOX_PAD``); a closest-hit ray takes its instances in the order it
    enters their boxes, and leaves out those it enters beyond its nearest
    hit so far."""

    def __init__(self, triangles: torch.Tensor, transforms: torch.Tensor,
                 dtype=torch.float32, skip: bool = True):
        self.object = Caster(triangles, dtype)
        self.num_tris = triangles.shape[0]
        x = transforms.to(torch.float64)
        inv = torch.linalg.inv(x[:, :, :3])
        det = torch.linalg.det(x[:, :, :3])
        self.inv = inv.float()
        self.offset = x[:, :, 3].float()
        self.det_eps = (DET_EPS / det.abs()).to(dtype)
        self.normals = InstanceNormals(flat_normals(triangles.float()),
                                       (inv.transpose(1, 2) * det.sign()[:, None, None]).float())
        self.rows = max(1, PAIR_ELEMS // max(self.num_tris, 1))
        self.skip = skip
        if skip:
            self.lo, self.hi = instance_boxes(triangles, transforms)
            pad = BOX_PAD * max(float(self.lo.abs().max()), float(self.hi.abs().max()), 1.0)
            self.lo, self.hi = self.lo - pad, self.hi + pad

    def _pairs(self, o, d, tmin, tmax):
        """(ray, instance, entry) of the pairs to test: with ``skip`` those
        whose box the ray's interval meets, in the order of entry; else
        every pair, entry None."""
        n, num = o.shape[0], self.offset.shape[0]
        dev = o.device
        if not self.skip:
            return (torch.arange(n, device=dev).repeat_interleave(num),
                    torch.arange(num, device=dev).repeat(n), None)
        inv_d = 1.0 / d
        t0 = (self.lo[None] - o[:, None]) * inv_d[:, None]
        t1 = (self.hi[None] - o[:, None]) * inv_d[:, None]
        near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
        # a direction parallel to a slab: inside it for all t, or never
        flat = (d == 0)[:, None, :]
        inside = (o[:, None] >= self.lo[None]) & (o[:, None] <= self.hi[None])
        inf = torch.full_like(near, torch.inf)
        near = torch.where(flat, torch.where(inside, -inf, inf), near)
        far = torch.where(flat, torch.where(inside, inf, -inf), far)
        enter = torch.maximum(near.amax(dim=-1), tmin[:, None])
        leave = torch.minimum(far.amin(dim=-1), tmax[:, None])
        ray, inst = (enter <= leave).nonzero(as_tuple=True)
        entry = enter[ray, inst]
        order = torch.argsort(entry, stable=True)
        return ray[order], inst[order], entry[order]

    def _test(self, o, d, tmin, tmax, ray, inst, any_hit: bool):
        a, b = self.inv[inst], self.offset[inst]
        oo = torch.einsum("nij,nj->ni", a, o[ray] - b)
        dd = torch.einsum("nij,nj->ni", a, d[ray])
        return self.object._block(oo, dd, tmin[ray], tmax[ray], any_hit,
                                  self.det_eps[inst, None])

    def _closest_block(self, o, d, tmin, tmax):
        n, num_t = o.shape[0], self.num_tris
        dev = o.device
        none = self.offset.shape[0] * num_t
        best_t = torch.full((n,), torch.inf, device=dev)
        best_id = torch.full((n,), none, dtype=torch.int64, device=dev)
        best_u = torch.zeros(n, device=dev)
        best_v = torch.zeros(n, device=dev)
        ray, inst, entry = self._pairs(o, d, tmin, tmax)
        for c in range(0, ray.shape[0], self.rows):
            r, i = ray[c:c + self.rows], inst[c:c + self.rows]
            if entry is not None:
                keep = entry[c:c + self.rows] <= best_t[r]
                r, i = r[keep], i[keep]
                if r.shape[0] == 0:
                    continue
            hit, t, tri, u, v = self._test(o, d, tmin, tmax, r, i, False)
            t = torch.where(hit, t, torch.inf)
            new_t = best_t.scatter_reduce(0, r, t, "amin")
            # of the hits at the ray's nearest t, the least id
            ids = torch.where(hit & (t == new_t[r]), i * num_t + tri, none)
            new_id = torch.where(best_t == new_t, best_id, none).scatter_reduce(
                0, r, ids, "amin")
            won = (ids == new_id[r]) & (ids < none)
            best_u[r[won]] = u[won]
            best_v[r[won]] = v[won]
            best_t, best_id = new_t, new_id
        hit = torch.isfinite(best_t)
        return hit, best_t, torch.where(hit, best_id, 0), best_u, best_v

    def closest(self, o, d, tmin, tmax):
        """(hit, t, id, u, v) per ray."""
        parts = [self._closest_block(o[i:i + INSTANCED_RAY_BLOCK], d[i:i + INSTANCED_RAY_BLOCK],
                                     tmin[i:i + INSTANCED_RAY_BLOCK],
                                     tmax[i:i + INSTANCED_RAY_BLOCK])
                 for i in range(0, o.shape[0], INSTANCED_RAY_BLOCK)]
        if not parts:
            z = torch.zeros(0, device=o.device)
            return z.bool(), z, z.long(), z, z
        return tuple(torch.cat(p) for p in zip(*parts))

    def occluded(self, o, d, tmin, tmax):
        """Whether any instance's triangle lies within [tmin, tmax] on each
        ray."""
        occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        for s in range(0, o.shape[0], INSTANCED_RAY_BLOCK):
            sl = slice(s, s + INSTANCED_RAY_BLOCK)
            ray, inst, _ = self._pairs(o[sl], d[sl], tmin[sl], tmax[sl])
            ray = ray + s
            for c in range(0, ray.shape[0], self.rows):
                r, i = ray[c:c + self.rows], inst[c:c + self.rows]
                keep = ~occ[r]
                r, i = r[keep], i[keep]
                if r.shape[0]:
                    occ[r[self._test(o, d, tmin, tmax, r, i, True)]] = True
        return occ


# ---------------------------------------------------------------------------
# The path tracer, pixel by pixel
# ---------------------------------------------------------------------------


def _sky(d):
    t = 0.5 * (d[:, 1] + 1.0)
    h = torch.tensor(SKY_HORIZON, device=d.device)
    z = torch.tensor(SKY_ZENITH, device=d.device)
    return h * (1.0 - t[:, None]) + z * t[:, None]


def _cosine_sample(n, u):
    r = torch.sqrt(u[:, 0])
    phi = 2.0 * math.pi * u[:, 1]
    lx, ly = r * torch.cos(phi), r * torch.sin(phi)
    lz = torch.sqrt(torch.clamp(1.0 - u[:, 0], min=0.0))
    sign = torch.where(n[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = torch.stack([1.0 + sign * n[:, 0] ** 2 * a, sign * b, -sign * n[:, 0]], dim=-1)
    bt = torch.stack([b, sign + n[:, 1] ** 2 * a, -n[:, 1]], dim=-1)
    return t * lx[:, None] + bt * ly[:, None] + n * lz[:, None]


def path_trace_pixels(caster: Caster, normals: torch.Tensor, albedo, light, cam: dict,
                      width: int, height: int, bounces: int, uniforms, pixels: torch.Tensor):
    """[P, 3] radiance of the given pixels: ``bounces`` diffuse bounces
    after the primary hit, next-event estimation toward ``light`` at every
    hit, the sky where a path escapes. ``uniforms[b]`` is bounce b's
    [W * H, 2] uniforms, indexed by pixel; ``normals`` are the shading
    normals [T, 3] (the scene's at rest)."""
    dev = pixels.device
    albedo = torch.as_tensor(albedo, dtype=torch.float32, device=dev)
    light = torch.as_tensor(light, dtype=torch.float32, device=dev)
    lc = torch.tensor(LIGHT_COLOUR, device=dev)
    o, d, tmin, tmax = primary_rays(cam, width, height, pixels, dev)
    max_t = float(cam["max_depth"])
    n = pixels.shape[0]
    radiance = torch.zeros(n, 3, device=dev)
    through = torch.ones(n, 3, device=dev)
    live = torch.arange(n, device=dev)  # the paths still alive
    for b in range(bounces + 1):
        if live.numel() == 0:
            break
        hit, t, tri, _, _ = caster.closest(o, d, tmin, tmax)
        radiance[live[~hit]] += through[~hit] * _sky(d[~hit])
        keep = hit.nonzero().squeeze(1)
        live, o, d, t, tri, th = live[keep], o[keep], d[keep], t[keep], tri[keep], through[keep]
        nrm = normals[tri]
        nrm = torch.where(((nrm * d).sum(-1) > 0.0)[:, None], -nrm, nrm)
        pos = o + d * t[:, None]
        to_l = light - pos
        dist = torch.linalg.vector_norm(to_l, dim=-1)
        ldir = to_l / torch.clamp(dist, min=1e-30)[:, None]
        shadow = caster.occluded(pos, ldir, torch.full_like(dist, SHADOW_TMIN), dist)
        ndotl = torch.clamp((nrm * ldir).sum(-1), min=0.0)
        lit = torch.where(shadow[:, None], 0.0, th * albedo * ndotl[:, None] * lc)
        radiance[live] += lit
        if b == bounces:
            break
        through = th * albedo
        o = pos + nrm * BOUNCE_OFFSET
        d = _cosine_sample(nrm, uniforms[b][pixels[live]])
        tmin = torch.full_like(dist, SHADOW_TMIN)
        tmax = torch.full_like(dist, max_t)
    return radiance


def path_uniforms(seed: int, num_pixels: int, bounces: int, device):
    """The path tracer's random stream: bounce b's [W * H, 2] uniforms,
    drawn in turn from a generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.rand((num_pixels, 2), generator=gen, device=device)
            for _ in range(bounces + 1)]


# ---------------------------------------------------------------------------
# Render modes
# ---------------------------------------------------------------------------

DEPTH, BOX_TESTS, TRIANGLE_TESTS, MATERIAL_ID, LODS, DIFFUSE, TEXTURE, TEXTURE_LIT, \
    TEXTURE_LIT_SHADOWS = range(9)
# modes whose colour is the program's own count of its tree's work: no
# tree-free reference exists, only the colour's form can be checked
COUNT_MODES = (BOX_TESTS, TRIANGLE_TESTS)


def _u8(x):
    return torch.trunc(torch.nan_to_num(x, nan=0.0)).clamp(0.0, 255.0)


def mode_colours(caster: Caster, normals, material: dict, light, cam: dict, width: int,
                 height: int, pixels: torch.Tensor, modes) -> dict:
    """{mode: [P, 4] float colours before the byte cast's rounding}, for an
    untextured scene of one material (every triangle material 0 of
    ``num_materials`` = 1): depth, material id, LOD (no texture: magenta),
    diffuse, flat texture and the Phong modes with and without shadows."""
    dev = pixels.device
    o, d, tmin, tmax = primary_rays(cam, width, height, pixels, dev)
    hit, t, tri, _, _ = caster.closest(o, d, tmin, tmax)
    n = pixels.shape[0]
    alpha = torch.full((n, 1), 255.0, device=dev)
    black = torch.zeros(n, 3, device=dev)
    lc = torch.tensor(LIGHT_COLOUR, device=dev)
    diffuse = torch.as_tensor(material["diffuse"], dtype=torch.float32, device=dev)
    ambient_k = torch.as_tensor(material["ambient"], dtype=torch.float32, device=dev)
    light = torch.as_tensor(light, dtype=torch.float32, device=dev)
    pos = o + d * torch.where(hit, t, 0.0)[:, None]
    nrm = normals[tri]

    def phong(shadows: bool):
        to_l = light - pos
        ldir = to_l / torch.linalg.vector_norm(to_l, dim=-1, keepdim=True)
        ndotl = torch.clamp((nrm * ldir).sum(-1), min=0.0)
        dif = ndotl[:, None] * lc
        if shadows:
            dist = torch.linalg.vector_norm(to_l, dim=-1)
            sh = caster.occluded(pos, to_l / torch.clamp(dist, min=1e-30)[:, None],
                                 torch.full_like(dist, SHADOW_TMIN), dist)
            dif = torch.where(sh[:, None], 0.0, dif)
        # the scene's material has no specular term
        col = (dif * diffuse + 0.2 * lc * ambient_k).clamp(0.0, 1.0) * 255.0
        return torch.where(hit[:, None], col, black)

    out = {}
    for m in modes:
        if m == DEPTH:
            g = torch.where(hit, t, 0.0) / float(cam["max_depth"])
            rgb = (torch.clamp(g, max=1.0) * 255.0)[:, None].expand(n, 3)
        elif m == MATERIAL_ID:
            # hue 0 of 1 material: HSV (0, 1, 1), pure red
            rgb = torch.where(hit[:, None], torch.tensor([255.0, 0.0, 0.0], device=dev), black)
        elif m == LODS:
            rgb = torch.tensor([255.0, 0.0, 255.0], device=dev).expand(n, 3)
        elif m in (DIFFUSE, TEXTURE_LIT):
            rgb = phong(False)
        elif m == TEXTURE:
            rgb = torch.where(hit[:, None], diffuse * 255.0, black)
        elif m == TEXTURE_LIT_SHADOWS:
            rgb = phong(True)
        else:
            continue
        out[m] = torch.cat([rgb, alpha], dim=1)
    return out
