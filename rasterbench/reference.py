"""The plain reference: the benchmark's own renderer, post and counters.

It implements the upstream program's semantics (our_gl.cpp:89-201,
main.cpp:39-262 and 269-786, as the program's NumPy oracle states them)
in plain PyTorch, on any device, from the plan's arrays alone.  It
imports nothing of the program.  Frozen copies, taken at commit
6e89d3a91fb6a69bf8fbc13207f16929040733f9, of the formulas of
``tinyrenderder_tpu_torch/oracle.py`` (``barycentric``,
``coverage_mask``, ``affine_z``, ``perspective_correct_bary``,
``triangle_setup_planes``, ``interp3``), of the Phong and Eye vertex and
fragment stages and the texture samplers of ``shaders.py`` and of the
post of ``ops/post.py``, each in the original's operation order.  Two
rules keep float32 results equal to the oracle's on the GPU: every
division is tensor by tensor (a CUDA division by a Python float
multiplies by the reciprocal), and square roots are taken in float64.

Where the oracle walks one triangle at a time, the reference tests
every pixel centre of every valid triangle's clipped bbox at once, in
blocks, and resolves each pixel to the first triangle of the smallest
depth that beats the depth the pass started from, which is what the
serial strict-less z-test leaves.  With ``stats`` it counts the serial
z-test's writes too: per pixel, the candidates that set a new running
minimum in submission order (a segmented running minimum after a sort).

``Reference(plan, device, dtype)``: ``dtype`` float32 is the reference;
bfloat16 is the control of ``control.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from rasterbench import geometry

W_EPS = 1e-12
DEGEN_EPS = 1e-12
DENOM_EPS = 1e-15
#: pixel candidates tested in one block
BLOCK = 1 << 23
#: varying channels per shader kind: uv 2 + position_eye 3 + normal_eye 3
VARYINGS = {"phong": 8, "eye": 8}

# shading constants (main.cpp:33-34, 39-262)
EYE_DIFFUSE_BRIGHTNESS_THRESHOLD = 0.85
EYE_SPECULAR_POWER_THRESHOLD = 5.0
PHONG = dict(key=1.0, key_spec=1.0, fill=0.35, rim=0.6, ambient=0.10, spec_scale=0.35)
EYE = dict(key=1.0, rim=0.6, ambient=0.1, spec_scale=1.5)

# SSAO (main.cpp:317-321)
AO_NUM_DIRECTIONS = 8
AO_STEPS_PER_DIRECTION = 8
AO_SAMPLE_RADIUS = 16.0
AO_OCCLUSION_THRESHOLD = 1e-3
AO_INTENSITY = 0.35

INT64_MAX = 2**63 - 1


@dataclass
class Frame:
    color: torch.Tensor              # (H, W, 3) uint8
    depth: torch.Tensor              # (H, W), the output depth
    stats: dict                      # the RenderStats fields (with ``stats``)
    work: list                       # per visible pass: the raster's counted work


def _c(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d divisor on ``like``'s device and dtype."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# the decision formulas (oracle.py)
# ---------------------------------------------------------------------------

def apply_mat4(m, v):
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    return torch.stack([((m[i, 0] * x + m[i, 1] * y) + m[i, 2] * z) + m[i, 3] * w
                        for i in range(4)], dim=-1)


def barycentric(ax, ay, bx, by, cx, cy, px, py):
    """our_gl.cpp:77-86; degenerate (|u.z| < 1e-12) gives (-1, 1, 1)."""
    s0x = cx - ax
    s0y = bx - ax
    s0z = ax - px
    s1x = cy - ay
    s1y = by - ay
    s1z = ay - py
    ux = s0y * s1z - s0z * s1y
    uy = s0z * s1x - s0x * s1z
    uz = s0x * s1y - s0y * s1x
    degen = torch.abs(uz) < DEGEN_EPS
    safe_uz = torch.where(degen, torch.ones_like(uz), uz)
    b0 = 1.0 - (ux + uy) / safe_uz
    b1 = uy / safe_uz
    b2 = ux / safe_uz
    return (torch.where(degen, -1.0, b0), torch.where(degen, 1.0, b1),
            torch.where(degen, 1.0, b2))


def perspective_correct_bary(b0, b1, b2, w0, w1, w2):
    """our_gl.cpp:168-185."""
    one = torch.ones_like(b0)
    zero = torch.zeros_like(b0)

    def inv(w):
        w = w + zero
        bad = torch.abs(w) <= W_EPS
        return torch.where(bad, zero, one / torch.where(bad, one, w))

    iw0, iw1, iw2 = inv(w0), inv(w1), inv(w2)
    denom = b0 * iw0 + b1 * iw1 + b2 * iw2
    fallback = torch.abs(denom) < DENOM_EPS
    safe = torch.where(fallback, one, denom)
    return (torch.where(fallback, b0, (b0 * iw0) / safe),
            torch.where(fallback, b1, (b1 * iw1) / safe),
            torch.where(fallback, b2, (b2 * iw2) / safe))


def triangle_setup(clip, vp, width: int, height: int) -> dict:
    """Whole-triangle rejects, NDC, screen xy, clamped bbox
    (our_gl.cpp:89-135)."""
    w = clip[..., 3]
    w_ok = (w > W_EPS).all(dim=-1)
    safe_w = torch.where(w == 0, torch.ones_like(w), w)
    ndc = clip / safe_w[..., None]
    z = ndc[..., 2]
    z_ok = ~((z < -1.0) | (z > 1.0)).all(dim=-1)
    finite = torch.isfinite(ndc)
    finite_ok = finite.flatten(-2).all(dim=-1)
    ndc = torch.where(finite, ndc, torch.zeros_like(ndc))
    screen4 = apply_mat4(vp, ndc)
    sx, sy = screen4[..., 0], screen4[..., 1]
    e1x = sx[..., 1] - sx[..., 0]
    e1y = sy[..., 1] - sy[..., 0]
    e2x = sx[..., 2] - sx[..., 0]
    e2y = sy[..., 2] - sy[..., 0]
    facing_ok = (e1x * e2y - e1y * e2x) > 0
    big = 2 ** 30

    def to_int(v):
        return torch.clamp(v, -big, big).to(torch.int32)

    min_x = torch.clamp(to_int(torch.floor(sx.amin(dim=-1))), min=0)
    max_x = torch.clamp(to_int(torch.ceil(sx.amax(dim=-1))), max=width - 1)
    min_y = torch.clamp(to_int(torch.floor(sy.amin(dim=-1))), min=0)
    max_y = torch.clamp(to_int(torch.ceil(sy.amax(dim=-1))), max=height - 1)
    bbox_ok = (min_x <= max_x) & (min_y <= max_y)
    return {"valid": w_ok & z_ok & finite_ok & facing_ok & bbox_ok, "sx": sx, "sy": sy,
            "z": z, "w": w, "bbox": torch.stack([min_x, max_x, min_y, max_y], dim=-1)}


def _bary_at(setup, tri, x, y):
    """(b0, b1, b2, z, covered) at pixel centres (x, y) of triangles ``tri``."""
    sx, sy, zz = setup["sx"][tri], setup["sy"][tri], setup["z"][tri]
    dtype = sx.dtype
    px = x.to(dtype) + 0.5
    py = y.to(dtype) + 0.5
    b0, b1, b2 = barycentric(sx[:, 0], sy[:, 0], sx[:, 1], sy[:, 1], sx[:, 2], sy[:, 2],
                             px, py)
    covered = ~((b0 < 0) | (b1 < 0) | (b2 < 0))
    z = b0 * zz[:, 0] + b1 * zz[:, 1] + b2 * zz[:, 2]
    return b0, b1, b2, z, covered & torch.isfinite(z)


def _order_key(z):
    """int64 keys that order as the float depths do (-0 as +0)."""
    z = z.to(torch.float32)
    z = torch.where(z == 0, torch.zeros_like(z), z)
    b = z.view(torch.int32).to(torch.int64)
    return torch.where(b >= 0, b, b ^ 0x7FFFFFFF)


# ---------------------------------------------------------------------------
# shading (shaders.py)
# ---------------------------------------------------------------------------

def dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def normalized3(v):
    length = torch.sqrt(dot3(v, v).to(torch.float64)).to(v.dtype)
    zero_len = length == 0
    safe = torch.where(zero_len, torch.ones_like(length), length)
    return torch.where(zero_len[..., None], v, v / safe[..., None])


def _pad(v, w: float):
    return torch.cat([v, torch.full(v.shape[:-1] + (1,), w, dtype=v.dtype, device=v.device)],
                     dim=-1)


def transform_dir(m, v):
    return apply_mat4(m, _pad(v, 0.0))[..., :3]


def _gather(tex, u, v):
    """Nearest, clamp to edge, truncating index (model.cpp:415-472)."""
    th, tw = tex.shape[0], tex.shape[1]

    def index(coord, size):
        t = torch.trunc(coord * float(size))
        t = torch.where(torch.abs(t) < 2.0 ** 31, t, torch.zeros_like(t)).to(torch.int32)
        return torch.clamp(t, 0, size - 1)

    return tex.reshape(th * tw, -1)[(index(v, th) * tw + index(u, tw)).long()]


def _samples(u_, uu, vv, normal_map: bool):
    dtype = uu.dtype
    base = _gather(u_["tex_diffuse"], uu, vv)[..., :3].to(dtype)
    if not normal_map:
        return base, None, None
    texel = _gather(u_["tex_normal"], uu, vv)[..., :3].to(dtype)
    nm = normalized3(texel / _c(255.0, uu) * 2.0 - 1.0)
    s = _gather(u_["tex_specular"], uu, vv)[..., 2].to(torch.float32)
    spec = (s / _c(255.0, s)).to(dtype)
    return base, nm, spec


def phong_fragment(shader: dict, u_: dict, vary: dict):
    """main.cpp:39-171 (the specular power is always 1)."""
    pos_eye, geom_normal = vary["position_eye"], vary["normal_eye"]
    base, nm, spec_val = _samples(u_, vary["uv"][..., 0], vary["uv"][..., 1], True)
    specular_power = torch.clamp(spec_val, min=1.0)
    brightness = ((base[..., 0] + base[..., 1]) + base[..., 2]) / _c(3.0 * 255.0, base)
    is_eye = ((brightness >= EYE_DIFFUSE_BRIGHTNESS_THRESHOLD)
              & (specular_power <= EYE_SPECULAR_POWER_THRESHOLD))
    nm_eye = transform_dir(u_["modelview"], nm)
    s = float(shader["normal_map_strength"])
    blended = geom_normal * (1.0 - s) + nm_eye * s
    final_normal = torch.where(is_eye[..., None], geom_normal, normalized3(blended))
    view_dir = normalized3(-pos_eye)
    key = u_["key_light_eye"]
    key_diffuse = torch.clamp(dot3(final_normal, key), min=0.0) * PHONG["key"]
    reflect_dir = normalized3(final_normal * (2.0 * dot3(final_normal, key))[..., None] - key)
    reflect_view = torch.clamp(dot3(reflect_dir, view_dir), min=0.0)
    key_specular = torch.where(reflect_view > 0.0, reflect_view,
                               torch.zeros_like(reflect_view)) * PHONG["key_spec"]
    fill_diffuse = torch.clamp(dot3(final_normal, u_["fill_light_eye"]), min=0.0) * PHONG["fill"]
    rim_diffuse = torch.clamp(dot3(final_normal, u_["rim_light_eye"]), min=0.0) * PHONG["rim"]
    total_diffuse = key_diffuse + fill_diffuse + rim_diffuse
    return (base * (PHONG["ambient"] + total_diffuse)[..., None]
            + 255.0 * (PHONG["spec_scale"] * key_specular)[..., None])


def eye_fragment(shader: dict, u_: dict, vary: dict):
    """main.cpp:176-262 (the specular exponent is always 8)."""
    pos_eye = vary["position_eye"]
    normal = normalized3(vary["normal_eye"])
    base = _samples(u_, vary["uv"][..., 0], vary["uv"][..., 1], False)[0]
    view_dir = normalized3(-pos_eye)
    key = u_["key_light_eye"]
    key_diffuse = torch.clamp(dot3(normal, key), min=0.0) * EYE["key"]
    rim_diffuse = torch.clamp(dot3(normal, u_["rim_light_eye"]), min=0.0) * EYE["rim"]
    total_diffuse = key_diffuse + rim_diffuse
    reflect_dir = normalized3(normal * (2.0 * dot3(normal, key))[..., None] - key)
    reflect_view = torch.clamp(dot3(reflect_dir, view_dir), min=0.0)
    x2 = reflect_view * reflect_view
    x4 = x2 * x2
    specular = x4 * x4
    return (base * (EYE["ambient"] + total_diffuse)[..., None]
            + 255.0 * (EYE["spec_scale"] * specular)[..., None])


FRAGMENTS = {"phong": phong_fragment, "eye": eye_fragment}


def finalize_color(rgb):
    """min(255, v), truncated to a byte (main.cpp:161-167)."""
    return torch.trunc(torch.clamp(rgb, max=255.0)).to(torch.int32).to(torch.uint8)


# ---------------------------------------------------------------------------
# post (ops/post.py)
# ---------------------------------------------------------------------------

def ssao_offsets() -> list[tuple[int, int]]:
    def c_round(v: float) -> int:
        return int(math.floor(v + 0.5)) if v >= 0 else -int(math.floor(-v + 0.5))

    taps = []
    for direction in range(AO_NUM_DIRECTIONS):
        angle = 2.0 * math.pi * direction / AO_NUM_DIRECTIONS
        dx, dy = math.cos(angle), math.sin(angle)
        for step in range(1, AO_STEPS_PER_DIRECTION + 1):
            radius = step / AO_STEPS_PER_DIRECTION * AO_SAMPLE_RADIUS
            taps.append((c_round(dx * radius), c_round(dy * radius)))
    return taps


def zbuffer_image(zbuffer):
    """main.cpp:269-314: 255 * (1 - normalized), infinite depth white."""
    finite = torch.isfinite(zbuffer)
    any_finite = finite.any()
    big = _c(1e9, zbuffer)
    zmin = torch.where(finite, zbuffer, big).amin()
    zmax = torch.where(finite, zbuffer, -big).amax()
    zmax = torch.where(zmax - zmin < 1e-7, zmin + 1e-7, zmax)
    denom = zmax - zmin
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    value = torch.trunc(255.0 * (1.0 - (zbuffer - zmin) / denom))
    value = torch.where(finite, value, 255.0)
    value = torch.where(any_finite, value, torch.full_like(value, 255.0))
    return torch.clamp(value, 0, 255).to(torch.uint8)


def ssao(zbuffer):
    """main.cpp:324-362 and 756-765: the AO byte per pixel."""
    h, w = zbuffer.shape
    pad = 17
    zpad = torch.full((h + 2 * pad, w + 2 * pad), torch.nan, dtype=zbuffer.dtype,
                      device=zbuffer.device)
    zpad[pad:pad + h, pad:pad + w] = zbuffer
    occluded = torch.zeros((h, w), dtype=torch.int32, device=zbuffer.device)
    total = torch.zeros_like(occluded)
    threshold_ref = zbuffer - AO_OCCLUSION_THRESHOLD
    for dx, dy in ssao_offsets():
        sample = zpad[pad + dy:pad + dy + h, pad + dx:pad + dx + w]
        total += (~torch.isnan(sample)).to(torch.int32)
        occluded += (torch.isfinite(sample) & (sample < threshold_ref)).to(torch.int32)
    ratio = occluded.to(zbuffer.dtype) / torch.clamp(total, min=1).to(zbuffer.dtype)
    ao = 1.0 - ratio * AO_INTENSITY
    ao = torch.where(total == 0, torch.ones_like(ao), ao)
    ao = torch.where(torch.isfinite(zbuffer), ao, torch.ones_like(ao))
    return torch.trunc(255.0 * ao).to(torch.uint8)


def post(color, depth) -> dict:
    """{zimg, ao, final}: main.cpp:756-786."""
    zimg = zbuffer_image(depth)
    ao = ssao(depth)
    prod = color.to(torch.int32) * ao.to(torch.int32)[..., None]
    final = torch.div(prod, 255, rounding_mode="floor").to(torch.uint8)
    return {"zimg": zimg, "ao": ao, "final": final}


# ---------------------------------------------------------------------------
# the frame
# ---------------------------------------------------------------------------

@dataclass
class _Pass:
    plan: object
    normals: np.ndarray
    aabb: geometry.AABB
    attrs: dict | None = None
    textures: dict | None = None


class Reference:
    """The plan's frames in ``dtype`` on ``device``."""

    def __init__(self, plan, device="cpu", dtype=torch.float32):
        self.plan = plan
        self.device = torch.device(device)
        self.dtype = dtype
        self.passes = [
            _Pass(p, geometry.generate_normals(p.mesh.positions, p.mesh.faces, p.mesh.normals),
                  geometry.local_aabb(p.mesh.positions))
            for p in plan.passes]

    def _attrs(self, rp: _Pass) -> dict:
        if rp.attrs is None:
            m, f = rp.plan.mesh, rp.plan.mesh.faces
            dev, dt = self.device, self.dtype
            rp.attrs = {k: torch.from_numpy(a[f].astype(np.float32)).to(dev).to(dt)
                        for k, a in (("position", m.positions), ("normal", rp.normals),
                                     ("uv", m.uvs))}
            rp.textures = {f"tex_{k}": torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                           for k, v in rp.plan.textures.items()}
        return rp.attrs

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a).astype(np.float32)).to(self.device).to(self.dtype)

    def render(self, eye, stats: bool = False) -> Frame:
        plan, cam = self.plan, self.plan.camera
        w, h = plan.width, plan.height
        view = geometry.lookat(eye, cam["target"], cam["up"])
        proj = geometry.perspective(float(cam["fov"]), w / h, float(cam["near"]),
                                    float(cam["far"]))
        st = {"triangles_rasterized": 0, "fragments_drawn": 0,
              "min_x": 2**31 - 1, "min_y": 2**31 - 1, "max_x": -2**31, "max_y": -2**31,
              "min_z": math.inf, "max_z": -math.inf, "models_rendered": 0,
              "models_culled": 0, "total_triangles": 0, "culled_triangles": 0}
        frustum = geometry.Frustum(proj @ view)
        visible = []
        for rp in self.passes:
            if plan.frustum_cull and not frustum.intersects(rp.aabb.transform(rp.plan.model)):
                st["models_culled"] += 1
                st["culled_triangles"] += rp.plan.mesh.nfaces
            else:
                st["models_rendered"] += 1
                st["total_triangles"] += rp.plan.mesh.nfaces
                visible.append(rp)
        zbuf = torch.full((h * w,), math.inf, dtype=self.dtype, device=self.device)
        color = torch.zeros((h * w, 3), dtype=torch.uint8, device=self.device)
        vp = self._t(geometry.viewport(0, 0, w, h))
        persp = self._t(proj)
        snapshot, in_excluded, work = None, False, []
        for rp in visible:
            if rp.plan.exclude_from_output_depth:
                if not in_excluded:
                    snapshot = zbuf.clone()                 # main.cpp:700
                    in_excluded = True
            elif in_excluded:
                zbuf = snapshot.clone()                     # main.cpp:730
                in_excluded = False
            work.append(self._pass(rp, view, persp, vp, zbuf, color, st, stats))
        depth = snapshot if in_excluded else zbuf
        return Frame(color=color.reshape(h, w, 3), depth=depth.reshape(h, w), stats=st,
                     work=work)

    def _uniforms(self, rp: _Pass, view: np.ndarray, persp: torch.Tensor) -> dict:
        mv = view @ rp.plan.model
        lt = self.plan.lights
        names = ("key", "fill", "rim") if rp.plan.shader["kind"] == "phong" else ("key", "rim")
        dirs = geometry.light_dirs_eye(mv, [lt[n] for n in names])
        u_ = {"modelview": self._t(mv), "perspective": persp}
        u_.update({f"{n}_light_eye": self._t(d) for n, d in zip(names, dirs)})
        u_.update(rp.textures)
        return u_

    def _pass(self, rp, view, persp, vp, zbuf, color, st, stats: bool) -> dict:
        plan = self.plan
        w, h = plan.width, plan.height
        attrs = self._attrs(rp)
        u_ = self._uniforms(rp, view, persp)
        mv = u_["modelview"]
        pos_eye4 = apply_mat4(mv, _pad(attrs["position"], 1.0))
        setup = triangle_setup(apply_mat4(persp, pos_eye4), vp, w, h)
        won, win_tri, work = resolve(setup, zbuf, w, h, st if stats else None)
        work["varyings"] = VARYINGS[rp.plan.shader["kind"]]
        work["pass"] = rp.plan.name
        if len(won) == 0:
            return work
        x, y = won % w, torch.div(won, w, rounding_mode="floor")
        b0, b1, b2, z, _ = _bary_at(setup, win_tri, x, y)
        wt = setup["w"][win_tri]
        pb0, pb1, pb2 = perspective_correct_bary(b0, b1, b2, wt[:, 0], wt[:, 1], wt[:, 2])
        corner = {"uv": attrs["uv"], "position_eye": pos_eye4[..., :3],
                  "normal_eye": transform_dir(mv, attrs["normal"])}
        vary = {}
        for name, vv in corner.items():
            v = vv[win_tri]
            vary[name] = (v[:, 0] * pb0[:, None] + v[:, 1] * pb1[:, None]
                          + v[:, 2] * pb2[:, None])
        rgb = FRAGMENTS[rp.plan.shader["kind"]](rp.plan.shader, u_, vary)
        color[won] = finalize_color(rgb)
        zbuf[won] = z
        return work


def resolve(setup: dict, zbuf, width: int, height: int, st: dict | None = None):
    """The pass's z-test over the flat depth buffer ``zbuf`` (read, not
    written) -> (pixels won, their triangles, counted work: valid
    triangles, pixel centres tested inside their clipped bboxes, pixels
    won, triangles that win one, the frame's pixels).  With ``st`` (the
    RenderStats fields) adds the pass's triangles, bbox and serial
    z-test writes to it."""
    n_faces = setup["valid"].shape[0]
    tri_ids = setup["valid"].nonzero().squeeze(1)
    bbox = setup["bbox"][tri_ids].to(torch.int64)
    nx = bbox[:, 1] - bbox[:, 0] + 1
    area = nx * (bbox[:, 3] - bbox[:, 2] + 1)
    area_h = area.cpu().numpy()
    if st is not None:
        st["triangles_rasterized"] += n_faces
        if len(tri_ids):
            lo = bbox.amin(0).tolist()
            hi = bbox.amax(0).tolist()
            st["min_x"] = min(st["min_x"], lo[0])
            st["max_x"] = max(st["max_x"], hi[1])
            st["min_y"] = min(st["min_y"], lo[2])
            st["max_y"] = max(st["max_y"], hi[3])
    dev = zbuf.device
    best = torch.full((height * width,), INT64_MAX, dtype=torch.int64, device=dev)
    kept = []
    ends = np.cumsum(area_h)
    a = 0
    while a < len(tri_ids):
        b = max(a + 1, int(np.searchsorted(ends, (ends[a - 1] if a else 0) + BLOCK,
                                           side="right")))
        cnt = area[a:b]
        local = torch.repeat_interleave(torch.arange(a, b, device=dev), cnt)
        starts = torch.cumsum(cnt, 0) - cnt
        off = torch.arange(local.shape[0], device=dev) - starts[local - a]
        x = bbox[local, 0] + off % nx[local]
        y = bbox[local, 2] + torch.div(off, nx[local], rounding_mode="floor")
        tri = tri_ids[local]
        _, _, _, z, covered = _bary_at(setup, tri, x, y)
        pix = y * width + x
        keep = covered & (z < zbuf[pix])
        pix, tri, z = pix[keep], tri[keep], z[keep]
        best.scatter_reduce_(0, pix, _order_key(z) * 2**32 + tri, "amin")
        if st is not None:
            kept.append((pix, tri, z))
        a = b
    won = (best != INT64_MAX).nonzero().squeeze(1)
    win_tri = best[won] & 0xFFFFFFFF
    if kept:
        _count_writes(kept, n_faces, st)
    work = {"valid": int(len(tri_ids)), "tests": int(area_h.sum()), "won": int(len(won)),
            "winning_triangles": int(torch.unique(win_tri).numel()),
            "pixels": width * height}
    return won, win_tri, work


def _count_writes(kept, n_faces: int, st: dict) -> None:
    """The serial z-test's writes: per pixel, the candidates (those
    that beat the starting depth) that set a new running minimum in
    submission order."""
    pix = torch.cat([k[0] for k in kept])
    tri = torch.cat([k[1] for k in kept])
    z = torch.cat([k[2] for k in kept])
    if pix.numel() == 0:
        return
    order = torch.argsort(pix * n_faces + tri)
    pix, z = pix[order], z[order]
    seg = (pix.max() + 1 - pix) * 2**33
    key = seg + (_order_key(z) + 2**31)
    running = torch.cummin(key, 0).values
    record = torch.ones_like(pix, dtype=torch.bool)
    record[1:] = key[1:] < running[:-1]
    zr = z[record]
    st["fragments_drawn"] += int(record.sum())
    st["min_z"] = min(st["min_z"], float(zr.min()))
    st["max_z"] = max(st["max_z"], float(zr.max()))
