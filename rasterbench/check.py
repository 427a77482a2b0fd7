"""The comparison that decides ``correct``.

Each frame sampled from the window (``loop.Sample``) is rendered again
by the configuration's plain reference (a module that
``catalog.Benchmark.reference`` finds: ``reference.py`` or one of
``references/``) at the same eye, and each output the traffic
mix's ``checks`` names is compared with what the program delivered:

  * ``<image>_px_off``: pixels of ``color``, ``zimg``, ``ao`` or
    ``final`` that differ in any channel;
  * ``depth_px_off``: pixels of the output depth that differ (infinite
    depths compare equal);
  * ``stats_off``: ``RenderStats`` counters that differ
    (``STATS_FIELDS``).

The program claims the upstream program's frames bit for bit, so each
limit is 0.  A number is the largest over the sampled frames; a frame
with any number over its limit counts as failed.
"""

from __future__ import annotations

import torch

STATS_FIELDS = ("triangles_rasterized", "fragments_drawn", "min_x", "min_y", "max_x",
                "max_y", "min_z", "max_z", "models_rendered", "models_culled",
                "total_triangles", "culled_triangles")


def _stat(stats, name):
    return stats[name] if isinstance(stats, dict) else getattr(stats, name)


def numbers(images: dict, depth, stats, ref, ref_images: dict, checks: dict) -> dict:
    """The compared numbers of one frame: ``images`` (host or device
    uint8), ``depth`` and ``stats`` from the side under test against the
    reference's ``Frame`` ``ref``."""
    out = {}
    for name in checks:
        if name == "depth_px_off":
            a = depth.to(ref.depth.device, torch.float32)
            b = ref.depth.to(torch.float32)
            out[name] = int((~((a == b) | (torch.isnan(a) & torch.isnan(b)))).sum())
        elif name == "stats_off":
            out[name] = sum(_stat(stats, f) != ref.stats[f] for f in STATS_FIELDS)
        else:
            image = name[:-len("_px_off")]
            a = images[image].to(ref.color.device)
            diff = a != ref_images[image]
            out[name] = int((diff.any(-1) if diff.dim() == 3 else diff).sum())
    return out


POST_IMAGES = ("zimg", "ao", "final")


def reference_images(reference, frame, checks: dict) -> dict:
    """The images of ``reference`` (the module) that ``checks`` compare,
    from its ``Frame`` ``frame``."""
    images = {"color": frame.color}
    if any(f"{n}_px_off" in checks for n in POST_IMAGES):
        images.update(reference.post(frame.color, frame.depth))
    return images


def program_frames(samples: list):
    """The side under test for ``compare``: the program's sampled frames
    (``loop.Sample``) as the window delivered them."""
    return lambda i, eye: (samples[i].images, samples[i].depth, samples[i].stats)


def compare(reference, plan, checks: dict, eyes: list, under_test,
            device) -> tuple[dict, int, list]:
    """Each of ``eyes`` rendered by ``reference`` (the module) against the
    side under test, ``under_test(i, eye) -> (images, depth, stats)`` of the i-th
    -> ({number: largest value over the frames}, frames failed, per frame
    the reference's counted work of each visible pass)."""
    ref = reference.Reference(plan, device)
    worst = {name: 0 for name in checks}
    failed, work = 0, []
    for i, eye in enumerate(eyes):
        frame = ref.render(eye, stats="stats_off" in checks)
        images, depth, stats = under_test(i, eye)
        got = numbers(images, depth, stats, frame,
                      reference_images(reference, frame, checks), checks)
        failed += any(got[n] > checks[n] for n in checks)
        worst = {n: max(worst[n], got[n]) for n in checks}
        work.append(frame.work)
    return worst, failed, work
