"""Route ``render``: ``Scene.render(device, frustum_cull, backend=...)``,
then ``ops.post.postprocess`` when the configuration has ``post``.  A
frame delivers the colour and, with post, the z-image, the AO and the
composite, as the program's CLI writes its four outputs."""


def outputs(plan) -> dict:
    h, w = plan.height, plan.width
    out = {"color": (h, w, 3)}
    if plan.post:
        out.update(zimg=(h, w), ao=(h, w), final=(h, w, 3))
    return out


def frame(loop, spans):
    """-> (device images by name, output depth, RenderStats)."""
    from tinyrenderder_tpu_torch.ops import post
    res = loop.scene.render(loop.device, frustum_cull=loop.plan.frustum_cull,
                            backend=loop.traffic["backend"])
    loop.render_done(spans)
    images = {"color": res.color}
    if loop.plan.post:
        with loop.device_span(spans, "post"):
            images["zimg"], images["ao"], images["final"] = post.postprocess(res.color,
                                                                             res.depth)
    return images, res.depth, res.stats
