"""The system under test, `tpu_pathtracer_torch`, as the benchmark drives
it: a Renderer built through the port's own API from the benchmark's
inputs, and the port's camera records. Everything the benchmark imports of
the port is imported here."""
from __future__ import annotations

import dataclasses


def build_renderer(config, inputs, device, cache_dir):
    """(Renderer, parts) of a configuration: the BVH from the port's
    builder and its content-hashed cache in cache_dir, the Renderer with
    the default RenderSettings it derives, then the configuration's
    `settings` over them. parts = (flat_bvh, materials, envmap, texture),
    what a preview Renderer is built from."""
    from tpu_pathtracer_torch.accel.cache import load_or_build
    from tpu_pathtracer_torch.scene.config import MatDesc, REFL_NAMES
    from tpu_pathtracer_torch.scene.mesh import TriangleMesh
    from tpu_pathtracer_torch.tracer.renderer import Renderer
    mesh, mats, envmap, texture = inputs
    fb = load_or_build(TriangleMesh(
        mesh["vertices"], mesh["indices"], mesh["uv"], mesh["normals"],
        mesh["material_ids"]), cache_dir=cache_dir)
    md = [MatDesc(**dict({k: tuple(v) if isinstance(v, list) else v
                          for k, v in m.items()},
                         refltype=REFL_NAMES[m["refltype"]])) for m in mats]
    W, H = config["width"], config["height"]
    r = Renderer(fb, md, envmap=envmap, texture=texture, width=W, height=H,
                 device=device)
    over = config.get("settings") or {}
    if over:
        r = Renderer(fb, md, envmap=envmap, texture=texture, width=W,
                     height=H, settings=dataclasses.replace(r.settings,
                                                            **over),
                     device=device)
    return r, (fb, md, envmap, texture)


def render_camera(orbit, width, height):
    """The port's RenderCamera of the benchmark's orbit camera."""
    from tpu_pathtracer_torch.scene.camera import RenderCamera
    res, pos, view, up, fov = orbit.fields(width, height)
    return RenderCamera(resolution=res, position=pos, view=view, up=up,
                        fov=fov)


def interactive_camera(orbit, width, height):
    """The port's InteractiveCamera in the orbit camera's state."""
    from tpu_pathtracer_torch.scene.camera import InteractiveCamera
    icam = InteractiveCamera()
    icam.center_position = tuple(orbit.center)
    icam.radius = orbit.radius
    icam.yaw = orbit.yaw
    icam.pitch = orbit.pitch
    icam.set_resolution(width, height)
    icam.set_fovx(orbit.fovx)
    return icam


def preview_renderer(renderer, parts, div):
    """The viewer's preview Renderer at 1/div of renderer's resolution, on
    its scene tensors."""
    from tpu_pathtracer_torch.tools.interactive import preview_renderer
    lo = preview_renderer(renderer, parts, div)
    if lo is None:
        raise ValueError("no exact 1/%d preview of %dx%d" % (
            div, renderer.width, renderer.height))
    return lo


def viewer_session(renderer, icam, lo, batch, out_dir,
                   snapshots_written=False):
    """A ViewerSession of the port's viewer on its real clock; its
    snapshots and camera file go to out_dir. snapshots_written: a session
    past its timed snapshots (SNAPSHOTS), which it then does not write."""
    import os
    from tpu_pathtracer_torch.tools.interactive import (
        SNAPSHOTS, ViewerSession)
    sess = ViewerSession(renderer, icam, lo, batch=batch,
                         cam_path=os.path.join(out_dir, "viewer.cam"),
                         out_dir=out_dir)
    if snapshots_written:
        sess.written.update(name for _, name in SNAPSHOTS)
    return sess


def _last_traced(renderer):
    """(key, integrator) of the renderer's last with_stats call, looked up
    among the integrators it has built (its cache, most recently used last;
    a key's first item names the integrator, `regen` or `bounce`, its
    third is with_stats), so that nothing is built here; None where no
    with_stats call ran."""
    ran = [(key, fn) for key, fn
           in getattr(renderer, "_integrators", {}).items() if key[2]]
    return ran[-1] if ran else None


def traced_waves(renderer):
    """{lanes: count} of the renderer's last with_stats call: a regen
    integrator's waves at each width (RegenIntegrator.last_waves); a bounce
    integrator's launched steps ({N: BounceIntegrator.last_launched}, N the
    lanes a step covers, W*H up to one lane chunk), the no-op steps
    launched after a frame's end among them, since each replays every
    kernel and stage mark of a step; {} where no with_stats call ran."""
    got = _last_traced(renderer)
    if got is None:
        return {}
    key, fn = got
    if key[0] == "bounce":
        n = min(renderer.width * renderer.height, renderer.lane_chunk)
        return {n: int(fn.last_launched)}
    return dict(fn.last_waves)


def counters(renderer):
    """{name: number}: what the integrator of the renderer's last with_stats
    call (_last_traced) published in its `last_counters` mapping (device
    scalars read back); {} where no with_stats call ran or its integrator
    publishes none."""
    got = _last_traced(renderer)
    pub = getattr(got[1], "last_counters", None) if got else None
    return {str(k): v.item() if hasattr(v, "item") else v
            for k, v in (pub or {}).items()}


def stream_rows(renderer):
    """Rows of the packed BVH stream the traversal reads."""
    return int(renderer.scene["packed"].shape[0])
