"""A configuration file and a seed -> the scene plan both sides render.

``make_plan`` reads a configuration (``configs/<name>.json``) and draws
from the run's seed the bump fields, the texture noise and the orbit's
first view; the meshes and textures come from the frozen generators of
``procedural``.  ``port_scene`` hands the same arrays to the program as
``Mesh`` objects (the program derives normals, tangents, packed
materials and uniforms from them itself); the configuration's
reference module (``catalog.Benchmark.reference``) takes the plan as it
is.  The configuration's keys that ``make_plan`` does not read reach
both sides as ``Plan.options``.  ``Orbit`` gives the eye of every
frame, from an integer view index, so both sides see the same float64
eye.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field

import numpy as np

from rasterbench import geometry, procedural

GENERATORS = {
    "uv_sphere": procedural.uv_sphere,
    "bumpy_head": procedural.bumpy_head,
    "cube": procedural.cube,
    "head_wall": procedural.head_wall,
    "mixed_interior": procedural.mixed_interior,
}
#: the generators whose keyword ``seed`` takes the run's bump seed
SEEDED = ("bumpy_head", "head_wall", "mixed_interior")
#: the configuration keys ``make_plan`` reads; the others are ``Plan.options``
READ = ("width", "height", "camera", "lights", "frustum_cull", "post", "passes")


@dataclass
class PassPlan:
    name: str
    mesh: procedural.MeshArrays
    textures: dict                   # diffuse, normal, specular: (s, s, 3) uint8
    shader: dict                     # {"kind": "phong"|"eye", ...}
    model: np.ndarray                # (4, 4) float64
    exclude_from_output_depth: bool = False


@dataclass
class Orbit:
    """The eye turned about +Y through the target, ``views`` to a turn."""

    eye: np.ndarray
    target: np.ndarray
    views: int
    first: int

    def eye_at(self, frame: int) -> np.ndarray:
        view = (self.first + frame) % self.views
        rot = geometry.rotation_y(2.0 * math.pi * view / self.views)
        return self.target + rot @ (self.eye - self.target)


@dataclass
class Plan:
    width: int
    height: int
    camera: dict                     # eye, target, up, fov, near, far
    lights: dict                     # key, fill, rim: normalized world directions
    frustum_cull: bool
    post: bool
    passes: list[PassPlan] = field(default_factory=list)
    orbit: Orbit | None = None
    sample_seed: int = 0
    #: a deep copy of the configuration's keys outside ``READ``, such as
    #: ``"reference"`` or a block a route or reference module reads
    options: dict = field(default_factory=dict)

    @property
    def faces(self) -> int:
        return sum(p.mesh.nfaces for p in self.passes)


def _mesh(spec: dict, bump_seed: int) -> procedural.MeshArrays:
    args = {k: v for k, v in spec.items() if k not in ("generator", "offset")}
    if spec["generator"] in SEEDED:
        args["seed"] = bump_seed
    m = GENERATORS[spec["generator"]](**args)
    if "offset" in spec:
        m.positions = m.positions + np.asarray(spec["offset"], dtype=np.float64)
    return m


def _textures(spec: dict, noise_seed: int) -> dict:
    tex = procedural.default_head_material(spec["size"])
    if spec.get("diffuse") == "noise":
        tex["diffuse"] = procedural.noise_texture(spec["size"], seed=noise_seed)
    return tex


def make_plan(config: dict, traffic: dict, seed: int) -> Plan:
    """The scene of ``config`` for run ``seed``: the same sizes for every
    seed, other bumps, noise and first view."""
    rng = np.random.default_rng(seed)
    views = int(traffic["views_per_revolution"])
    first = int(rng.integers(views))
    bump_seed, noise_seed, sample_seed = (int(v) for v in rng.integers(2**31, size=3))
    cam = config["camera"]
    lights = {k: geometry.normalized(np.asarray(v, dtype=np.float64))
              for k, v in config["lights"].items()}
    plan = Plan(width=int(config["width"]), height=int(config["height"]),
                camera=dict(cam), lights=lights, frustum_cull=bool(config["frustum_cull"]),
                post=bool(config["post"]), sample_seed=sample_seed,
                options=copy.deepcopy({k: v for k, v in config.items() if k not in READ}))
    for spec in config["passes"]:
        model = spec.get("model", {})
        plan.passes.append(PassPlan(
            name=spec["name"], mesh=_mesh(spec["mesh"], bump_seed),
            textures=_textures(spec["material"], noise_seed), shader=dict(spec["shader"]),
            model=geometry.model_matrix(model.get("scale", 1.0),
                                        model.get("translate", (0.0, 0.0, 0.0))),
            exclude_from_output_depth=bool(spec.get("exclude_from_output_depth", False))))
    plan.orbit = Orbit(eye=np.asarray(cam["eye"], dtype=np.float64),
                       target=np.asarray(cam["target"], dtype=np.float64),
                       views=views, first=first)
    return plan


def port_scene(plan: Plan):
    """The plan as the program's ``Scene``: its ``Camera``, one ``Mesh``
    (finalized by the program) and shader object per pass."""
    from tinyrenderder_tpu_torch.camera import Camera
    from tinyrenderder_tpu_torch.models.mesh import Material, Mesh
    from tinyrenderder_tpu_torch.scene import Scene
    from tinyrenderder_tpu_torch.shaders import EyeShader, PhongShader

    cam = Camera()
    c = plan.camera
    cam.set_up(np.asarray(c["up"], dtype=np.float64))
    cam.set_eye(np.asarray(c["eye"], dtype=np.float64))
    cam.set_target(np.asarray(c["target"], dtype=np.float64))
    cam.set_fov(float(c["fov"]))
    cam.set_aspect(plan.width / plan.height)
    cam.set_clipping(float(c["near"]), float(c["far"]))
    scene = Scene(camera=cam, width=plan.width, height=plan.height)
    lt = plan.lights
    for p in plan.passes:
        m = p.mesh
        mesh = Mesh(positions=m.positions.copy(), faces=m.faces.copy(),
                    normals=None if m.normals is None else m.normals.copy(),
                    uvs=m.uvs.copy(), name=p.name)
        mesh.materials = [Material(name=p.name, diffuse=p.textures["diffuse"],
                                   normal=p.textures["normal"],
                                   specular=p.textures["specular"])]
        mesh.finalize()
        kind = p.shader["kind"]
        if kind == "phong":
            shader = PhongShader(lt["key"], lt["fill"], lt["rim"],
                                 normal_map_strength=float(p.shader["normal_map_strength"]))
        elif kind == "eye":
            shader = EyeShader(lt["key"], lt["rim"])
        else:
            raise ValueError(f"shader kind {kind!r}")
        scene.add(mesh, p.model.copy(), shader, name=p.name,
                  exclude_from_output_depth=p.exclude_from_output_depth)
    return scene
