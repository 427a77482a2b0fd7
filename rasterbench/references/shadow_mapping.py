"""The plain reference of the shadow-mapped frame (ssloy/tinyrenderer,
"Lesson 7: Shadow mapping"): a depth-only pass from the light fills an
S x S shadow buffer, then the lit pass tests each fragment against it.

It is ``reference.py``'s frame and formulas (imported from there) with
what the two passes add, and imports nothing of the program and no JAX.
Frozen copies, taken at commit ca09e0bd35cfcac3df9a5c934a9e0d570400bed5,
of ``light_camera_for_scene`` and ``_merged_world_mesh`` in
``tinyrenderder_tpu_torch/shadows.py`` and of ``ShadowMappedShader``'s
device fragment (``_shadow_factor``, ``_shadow_fragment``) in
``tinyrenderder_tpu_torch/shaders.py``, each in the original's
operation order.  Per frame, in the program's order:

  * the sun (``sun``): the configured light turned about +Y through the
    target by the angle that takes the configured eye to this eye.  A
    function of the float64 eye alone; the route imports it from here,
    so both sides light the frame from the same direction;
  * the light camera (``light_camera``): looking down the sun at the
    centre of every pass's world AABB, framing their bounding sphere;
  * the merged world mesh: every pass's positions with its model matrix
    baked in (the w divide included), one depth-only pass;
  * the light pass: ``reference.resolve`` at S x S from +inf, each pixel
    won taking its winner's depth (the map);
  * the lit frame: ``reference.Reference``'s frame with the configured
    light turned to the sun in every pass, each Phong pass shaded as
    ``ShadowMappedShader``: the model-space position interpolated as a
    fourth varying, mapped by the float32 model -> light-screen matrix,
    the map read at the truncated texel, and ``amb + (rgb - amb) *
    factor`` with factor 1 (lit: off the map, behind the light, or the
    map's depth above the fragment's less ``SHADOW_EPS``) or
    ``SHADOW_AMBIENT_FACTOR``.  The Eye pass is lit by the sun,
    unshadowed.

Stats cover the lit passes only.  ``Frame.work`` lists the light pass
first, named ``light``, with no varyings, then the lit passes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rasterbench import geometry, reference
from rasterbench.reference import Frame, apply_mat4, _c, _pad

#: the shadow test (ShadowMappedShader): the lit terms' factor in shadow,
#: and the depth bias in the light's NDC z
SHADOW_AMBIENT_FACTOR = 0.3
SHADOW_EPS = 2e-3
#: varying channels per shader kind in the lit pass: a shadowed Phong pass
#: adds the model-space position (3) to uv 2 + position_eye 3 + normal_eye 3
VARYINGS = {"phong": 11, "eye": 8}

post = reference.post


def sun(plan, eye) -> np.ndarray:
    """The world direction of the shadow-casting light for ``eye``
    (float64): ``plan.options["shadows"]["light"]`` turned about +Y
    through the target as the configured eye turns to ``eye``; the
    configured eye gives the configured light itself."""
    opts = plan.options["shadows"]
    if opts["sun"] != "turns_with_eye":
        raise ValueError(f"sun rule {opts['sun']!r}")
    target = np.asarray(plan.camera["target"], dtype=np.float64)
    d0 = np.asarray(plan.camera["eye"], dtype=np.float64) - target
    d1 = np.asarray(eye, dtype=np.float64) - target
    angle = math.atan2(d1[0], d1[2]) - math.atan2(d0[0], d0[2])
    return geometry.rotation_y(angle) @ plan.lights[opts["light"]]


def light_camera(boxes: list, light_dir, fov_margin: float,
                 distance_factor: float) -> tuple[np.ndarray, np.ndarray]:
    """(view, projection) of the square light camera that looks down
    ``light_dir`` at the centre of world AABBs ``boxes`` and frames their
    bounding sphere (``light_camera_for_scene``)."""
    lo = np.min([b.min for b in boxes], axis=0)
    hi = np.max([b.max for b in boxes], axis=0)
    center = (lo + hi) * 0.5
    radius = max(float(np.linalg.norm(hi - lo)) * 0.5, 1e-3)
    d = geometry.normalized(np.asarray(light_dir, dtype=np.float64))
    dist = radius * distance_factor
    up = (0.0, 1.0, 0.0) if abs(d[1]) < 0.99 else (1.0, 0.0, 0.0)
    fov = 2.0 * np.degrees(np.arctan2(radius, dist)) * fov_margin
    view = geometry.lookat(center + d * dist, center, np.asarray(up))
    proj = geometry.perspective(float(np.clip(fov, 10.0, 120.0)), 1.0,
                                max(dist - radius * 1.5, radius * 1e-3), dist + radius * 1.5)
    return view, proj


def shadow_factor(u_: dict, vary: dict):
    """1 where the fragment is lit, ``SHADOW_AMBIENT_FACTOR`` where the
    map's depth at its light-screen texel is below its own by more than
    ``SHADOW_EPS`` (``_shadow_factor``)."""
    sm = u_["shadow_map"]
    p4 = apply_mat4(u_["shadow_matrix"], _pad(vary["position_model"], 1.0))
    w = p4[..., 3]
    safe_w = torch.where(w == 0, torch.ones_like(w), w)
    sx, sy, sz = p4[..., 0] / safe_w, p4[..., 1] / safe_w, p4[..., 2] / safe_w
    h, wdt = sm.shape

    def index(coord, size):
        t = torch.trunc(coord)
        t = torch.where(torch.abs(t) < 2.0 ** 31, t, torch.zeros_like(t)).to(torch.int32)
        return torch.clamp(t, 0, size - 1)

    inside = (sx >= 0) & (sx < wdt) & (sy >= 0) & (sy < h) & (w > 0)
    closest = sm.reshape(h * wdt)[(index(sy, h) * wdt + index(sx, wdt)).long()]
    lit = (~inside) | (closest > sz - _c(SHADOW_EPS, sz))
    return torch.where(lit, _c(1.0, sx), _c(SHADOW_AMBIENT_FACTOR, sx))


def shadowed_phong_fragment(shader: dict, u_: dict, vary: dict):
    """Phong with everything but the ambient term gated by the shadow
    factor (``_shadow_fragment``)."""
    rgb = reference.phong_fragment(shader, u_, vary)
    base = reference._samples(u_, vary["uv"][..., 0], vary["uv"][..., 1], False)[0]
    amb = base * reference.PHONG["ambient"]
    return amb + (rgb - amb) * shadow_factor(u_, vary)[..., None]


FRAGMENTS = {"phong": shadowed_phong_fragment, "eye": reference.eye_fragment}


class Reference(reference.Reference):
    """The plan's shadow-mapped frames in ``dtype`` on ``device``; the
    plan's ``options["shadows"]`` gives the map's side (``size``), the
    light frustum's ``fov_margin`` and ``distance_factor``, the ``light``
    that casts and the ``sun`` rule."""

    def __init__(self, plan, device="cpu", dtype=torch.float32):
        super().__init__(plan, device, dtype)
        opts = plan.options["shadows"]
        self.size = int(opts["size"])
        self.fov_margin = float(opts["fov_margin"])
        self.distance_factor = float(opts["distance_factor"])
        self.light = opts["light"]
        self.lights = dict(plan.lights)
        #: the frame's (light viewport @ projection @ view, map)
        self.shadow = None
        self._merged = None

    def render(self, eye, stats: bool = False) -> Frame:
        s = self.size
        turned = sun(self.plan, eye)
        view_l, proj_l = light_camera([rp.aabb.transform(rp.plan.model) for rp in self.passes],
                                      turned, self.fov_margin, self.distance_factor)
        smap, work = self.light_pass(view_l, proj_l)
        self.lights = dict(self.plan.lights, **{self.light: turned})
        self.shadow = (geometry.viewport(0, 0, s, s) @ proj_l @ view_l, smap)
        frame = super().render(eye, stats)
        frame.work.insert(0, work)
        return frame

    def merged_positions(self) -> torch.Tensor:
        """The merged world mesh's (F, 3, 3) face-corner positions
        (``_merged_world_mesh``), built once."""
        if self._merged is None:
            pos, fac, offset = [], [], 0
            for rp in self.passes:
                p, m = rp.plan.mesh.positions.copy(), rp.plan.model
                ph = p @ m[:3, :3].T + m[:3, 3]
                w = (p @ m[3:4, :3].T + m[3, 3]).reshape(-1, 1)
                pos.append(ph / w)
                fac.append(rp.plan.mesh.faces + offset)
                offset += p.shape[0]
            self._merged = self._t(np.concatenate(pos)[np.concatenate(fac)])
        return self._merged

    def light_pass(self, view_l: np.ndarray, proj_l: np.ndarray):
        """-> (the (S, S) map, +inf where nothing is drawn; the pass's
        counted work)."""
        s = self.size
        pos_eye4 = apply_mat4(self._t(view_l @ np.eye(4)), _pad(self.merged_positions(), 1.0))
        setup = reference.triangle_setup(apply_mat4(self._t(proj_l), pos_eye4),
                                         self._t(geometry.viewport(0, 0, s, s)), s, s)
        smap = torch.full((s * s,), math.inf, dtype=self.dtype, device=self.device)
        won, win_tri, work = reference.resolve(setup, smap, s, s)
        if len(won):
            x, y = won % s, torch.div(won, s, rounding_mode="floor")
            smap[won] = reference._bary_at(setup, win_tri, x, y)[3]
        work["varyings"] = 0
        work["pass"] = "light"
        return smap.reshape(s, s), work

    def _uniforms(self, rp, view: np.ndarray, persp: torch.Tensor) -> dict:
        mv = view @ rp.plan.model
        lt = self.lights
        phong = rp.plan.shader["kind"] == "phong"
        names = ("key", "fill", "rim") if phong else ("key", "rim")
        dirs = geometry.light_dirs_eye(mv, [lt[n] for n in names])
        u_ = {"modelview": self._t(mv), "perspective": persp}
        u_.update({f"{n}_light_eye": self._t(d) for n, d in zip(names, dirs)})
        u_.update(rp.textures)
        if phong:
            u_["shadow_matrix"] = self._t(self.shadow[0] @ rp.plan.model)
            u_["shadow_map"] = self.shadow[1]
        return u_

    def _pass(self, rp, view, persp, vp, zbuf, color, st, stats: bool) -> dict:
        plan = self.plan
        w, h = plan.width, plan.height
        kind = rp.plan.shader["kind"]
        attrs = self._attrs(rp)
        u_ = self._uniforms(rp, view, persp)
        mv = u_["modelview"]
        pos_eye4 = apply_mat4(mv, _pad(attrs["position"], 1.0))
        setup = reference.triangle_setup(apply_mat4(persp, pos_eye4), vp, w, h)
        won, win_tri, work = reference.resolve(setup, zbuf, w, h, st if stats else None)
        work["varyings"] = VARYINGS[kind]
        work["pass"] = rp.plan.name
        if len(won) == 0:
            return work
        x, y = won % w, torch.div(won, w, rounding_mode="floor")
        b0, b1, b2, z, _ = reference._bary_at(setup, win_tri, x, y)
        wt = setup["w"][win_tri]
        pb0, pb1, pb2 = reference.perspective_correct_bary(b0, b1, b2, wt[:, 0], wt[:, 1],
                                                           wt[:, 2])
        corner = {"uv": attrs["uv"], "position_eye": pos_eye4[..., :3],
                  "normal_eye": reference.transform_dir(mv, attrs["normal"])}
        if kind == "phong":
            corner["position_model"] = attrs["position"]
        vary = {}
        for name, vv in corner.items():
            v = vv[win_tri]
            vary[name] = (v[:, 0] * pb0[:, None] + v[:, 1] * pb1[:, None]
                          + v[:, 2] * pb2[:, None])
        rgb = FRAGMENTS[kind](rp.plan.shader, u_, vary)
        color[won] = reference.finalize_color(rgb)
        zbuf[won] = z
        return work
