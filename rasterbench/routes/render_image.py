"""Route ``render_image``: ``Scene.render_image(device, frustum_cull,
backend=...)``, the single-pass image route.  A frame delivers the
colour."""


def outputs(plan) -> dict:
    return {"color": (plan.height, plan.width, 3)}


def frame(loop, spans):
    """-> (device images by name, None, None): the route has no output
    depth and no stats."""
    color = loop.scene.render_image(loop.device, frustum_cull=loop.plan.frustum_cull,
                                    backend=loop.traffic["backend"])
    loop.render_done(spans)
    return {"color": color}, None, None
