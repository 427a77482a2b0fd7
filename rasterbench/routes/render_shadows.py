"""Route ``render_shadows``: the shadow-mapped frame of a configuration
with a ``"shadows"`` block.  Each frame turns the shadow-casting light
to the sun of the frame's eye (the ``sun`` of the configuration's
reference module, so both sides light the frame from one float64
direction), rebinds it as ``key_light_world`` on each Phong and Eye
shader of the scene, calls ``Scene.render(device, frustum_cull,
backend=..., shadows=(sun, settings))``, then ``ops.post.postprocess``
when the configuration has ``post``.  A frame delivers what route
``render`` delivers: the colour and, with post, the z-image, the AO and
the composite."""

import importlib


def outputs(plan) -> dict:
    h, w = plan.height, plan.width
    out = {"color": (h, w, 3)}
    if plan.post:
        out.update(zimg=(h, w), ao=(h, w), final=(h, w, 3))
    return out


def frame(loop, spans):
    """-> (device images by name, output depth, RenderStats)."""
    from tinyrenderder_tpu_torch.ops import post
    from tinyrenderder_tpu_torch.shaders import EyeShader, PhongShader
    from tinyrenderder_tpu_torch.shadows import ShadowSettings
    plan = loop.plan
    opts = plan.options["shadows"]
    ref = importlib.import_module(f"rasterbench.references.{plan.options['reference']}")
    sun = ref.sun(plan, loop.scene.camera.params.eye)
    for p in loop.scene.passes:
        if isinstance(p.shader, (PhongShader, EyeShader)):
            p.shader.key_light_world = sun
    settings = ShadowSettings(size=int(opts["size"]), fov_margin=float(opts["fov_margin"]),
                              distance_factor=float(opts["distance_factor"]))
    res = loop.scene.render(loop.device, frustum_cull=plan.frustum_cull,
                            backend=loop.traffic["backend"], shadows=(sun, settings))
    loop.render_done(spans)
    images = {"color": res.color}
    if plan.post:
        with loop.device_span(spans, "post"):
            images["zimg"], images["ao"], images["final"] = post.postprocess(res.color,
                                                                             res.depth)
    return images, res.depth, res.stats
