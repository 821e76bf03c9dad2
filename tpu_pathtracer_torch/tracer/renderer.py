"""Progressive renderer: camera rays and frame accumulation (port of
tracer/renderer.py).

The accumulation buffer is lane-ordered like the JAX package's: lane i
holds pixel lane_pixel_xy(i), lanes walking 32x32 pixel blocks, so that
neighbouring lanes trace neighbouring pixels. accum_to_buffer un-swizzles
it into an [H,W,3] image.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.rng import RaySampler
from ..core.vecmath import TWO_PI, PI, normalize, dot, cross
from ..scene.config import materials_to_arrays, MAT_SUBSURFACE
from ..scene.camera import RenderCamera
from ..scene.texture import make_quad_texture
from ..convert import to_device
from .traverse import pack_stream
from .wavefront import (
    RenderSettings, pack_tri_attributes, pack_mat_table, pack_envtex_quad,
)
from .envsample import build_env_distribution


@functools.lru_cache(maxsize=2)
def _bssrdf_table_cached(g=0.0, eta=1.4):
    from ..bssrdf.tabulate import compute_beam_diffusion_table
    return compute_beam_diffusion_table(g=g, eta=eta)


def lane_pixel_xy(pixel_index, width, height, block=32):
    """Closed-form lane -> (px, py) of the 32x32 block swizzle, int32,
    including the clipped blocks at the right and bottom edges."""
    b = int(block)
    W, H = int(width), int(height)
    i = pixel_index.to(torch.int64)
    full_rows = H // b
    rem_h = H - full_rows * b
    full_cols = W // b
    rem_w = W - full_cols * b
    row_lanes = W * b                     # lanes per full-height block row
    blk_row = i // row_lanes
    l2 = i - blk_row * row_lanes
    bh_cur = torch.where(blk_row < full_rows, b, max(rem_h, 1))
    blk_lanes = b * bh_cur
    col_blk = l2 // blk_lanes
    l3 = l2 - col_blk * blk_lanes
    bw_cur = torch.where(col_blk < full_cols, b, max(rem_w, 1))
    px = col_blk * b + l3 % bw_cur
    py = blk_row * b + l3 // bw_cur
    return (torch.clamp(px, 0, W - 1).to(torch.int32),
            torch.clamp(py, 0, H - 1).to(torch.int32))


def _unit(v):
    return v / torch.sqrt(dot(v, v))


def generate_camera_rays(cam_vec, rng, pixel_x, pixel_y):
    """Primary rays: AA jitter + thin-lens DOF (src/renderkernel.cu:895-954).

    cam_vec: [16] f32 (RenderCamera.as_array). pixel_x, pixel_y: [N] f32
    pixel coordinates. Four RNG draws per lane. Returns (rng, orig, dir)."""
    res_x, res_y = cam_vec[0], cam_vec[1]
    cam_pos = cam_vec[2:5]
    view = _unit(cam_vec[5:8])
    up = _unit(cam_vec[8:11])
    fov_x, fov_y = cam_vec[11], cam_vec[12]
    aperture = cam_vec[13]
    focal = cam_vec[14]

    horiz_axis = _unit(cross(view, up))
    vert_axis = _unit(cross(horiz_axis, view))
    middle = cam_pos + view
    horizontal = horiz_axis * torch.tan(fov_x * 0.5 * (PI / 180.0))
    vertical = vert_axis * torch.tan(-fov_y * 0.5 * (PI / 180.0))

    rng, (jx, jy, r1, r2) = RaySampler.next_n(rng, 4)
    sx = (jx - 0.5 + pixel_x) / (res_x - 1.0)
    sy = (jy - 0.5 + pixel_y) / (res_y - 1.0)
    point_on_plane = middle[None, :] \
        + (2.0 * sx - 1.0)[:, None] * horizontal[None, :] \
        + (2.0 * sy - 1.0)[:, None] * vertical[None, :]
    point_on_image = cam_pos[None, :] \
        + (point_on_plane - cam_pos[None, :]) * focal

    angle = TWO_PI * r1
    dist = aperture * torch.sqrt(r2)
    ap_x = torch.cos(angle) * dist
    ap_y = torch.sin(angle) * dist
    aperture_point = cam_pos[None, :] + horiz_axis[None, :] * ap_x[:, None] \
        + vert_axis[None, :] * ap_y[:, None]
    aperture_point = torch.where(aperture > 1e-5, aperture_point,
                                 cam_pos.expand(aperture_point.shape))
    return rng, aperture_point, normalize(point_on_image - aperture_point)


def lane_tables(width, height, block=32):
    """(lane_px, lane_py) int32 tables of the block swizzle (host numpy)."""
    bs = block
    W, H = int(width), int(height)
    bw = -(-W // bs)
    lanes = np.arange(bw * -(-H // bs) * bs * bs, dtype=np.int64)
    blk = lanes // (bs * bs)
    within = lanes % (bs * bs)
    px = (blk % bw) * bs + within % bs
    py = (blk // bw) * bs + within // bs
    valid = (px < W) & (py < H)
    return (px[valid][:W * H].astype(np.int32),
            py[valid][:W * H].astype(np.int32))


def build_scene(flat_bvh, mat_arrays, envmap, texture, settings, env_const,
                lane_px, lane_py):
    """The scene dict on the host (numpy arrays and Python ints), with the
    keys and values of the JAX package's Renderer.scene."""
    scene = {
        "prims": np.asarray(flat_bvh.prims, np.float32),
        "meta": np.asarray(flat_bvh.meta, np.int32),
        "packed": pack_stream(flat_bvh.prims, flat_bvh.meta),
        "num_nodes": int(flat_bvh.num_nodes),
        "tri_attr": pack_tri_attributes(
            flat_bvh.tri_pos, flat_bvh.tri_uv, flat_bvh.tri_nrm,
            flat_bvh.tri_mat, prims=flat_bvh.prims,
            num_nodes=flat_bvh.num_nodes),
        "tri_mat": np.asarray(flat_bvh.tri_mat, np.int32),
        "mat_table": pack_mat_table(mat_arrays),
        "env_const": np.asarray(env_const, np.float32),
    }
    if settings.has_bssrdf:
        # the photon-beam-diffusion table (g=0, eta=1.4, 100x64) of the
        # reference's initBssrdfTable (src/main.cpp:408-415), read by the
        # tabulated profile path (bssrdf_use_soe=False)
        tbl = _bssrdf_table_cached()
        scene["bssrdf_rho"] = np.asarray(tbl.rho, np.float32)
        scene["bssrdf_radius"] = np.asarray(tbl.radius, np.float32)
        scene["bssrdf_profile"] = np.asarray(tbl.profile, np.float32)
        scene["bssrdf_cdf"] = np.asarray(tbl.profile_cdf, np.float32)
        scene["bssrdf_rho_eff"] = np.asarray(tbl.rho_eff, np.float32)
    if envmap is not None:
        env = np.asarray(envmap, np.float32)
        equad = make_quad_texture(env, wrap_u=False, wrap_v=False)
        scene["env_h"], scene["env_w"] = env.shape[0], env.shape[1]
        if settings.env_importance_sampling:
            dist = build_env_distribution(env, topk=settings.env_nee_topk)
            scene.update(dist)
            # the sampler pdf of the 4 corner texels rides each quad row
            # (cols 12:16) so one gather gives radiance and pdf
            p = dist["env_pdf_uv"].astype(np.float32)
            pxn = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
            pyn = np.concatenate([p[1:], p[-1:]], axis=0)
            pyxn = np.concatenate([pxn[1:], pxn[-1:]], axis=0)
            pq = np.stack([p, pxn, pyn, pyxn], axis=-1).reshape(-1, 4)
            equad = np.concatenate([equad, pq], axis=1)
        scene["envmap_quad"] = equad
    if texture is not None:
        tex = np.asarray(texture, np.float32)
        tquad = make_quad_texture(tex, wrap_u=True, wrap_v=True)
        scene["texture_quad"] = tquad
        scene["tex_h"], scene["tex_w"] = tex.shape[0], tex.shape[1]
        if (envmap is not None and settings.env_importance_sampling
                and settings.use_texture):
            scene["envtex_quad"] = pack_envtex_quad(equad, tquad)
    # lane tables padded as the JAX Renderer pads them (to whole lane
    # chunks of at most 2^23, plus 8192)
    n = lane_px.shape[0]
    chunk = min(n, 1 << 23)
    n_pad = -(-n // chunk) * chunk - n + 8192
    scene["lane_px"] = np.pad(lane_px, (0, n_pad))
    scene["lane_py"] = np.pad(lane_py, (0, n_pad))
    return scene


class Renderer:
    """Scene tensors on one device plus the regen frame loop.

        r = Renderer(flat_bvh, materials, envmap=..., texture=..., width=W,
                     height=H, device="cuda")
        accum = r.render_frames(r.zeros_accum(), camera, 1, spp)
        img = r.accum_to_image(accum, spp)
    """

    def __init__(self, flat_bvh, materials, envmap=None, texture=None,
                 width=512, height=512, settings: RenderSettings = None,
                 env_const=(0.0, 0.0, 0.0), *, device):
        self.width = int(width)
        self.height = int(height)
        self.device = torch.device(device)
        mat_arrays = materials_to_arrays(materials)
        has_bssrdf = bool(np.any(mat_arrays["refltype"] == MAT_SUBSURFACE))
        has_media = bool(np.any(mat_arrays["has_medium"] != 0))
        if settings is None:
            settings = RenderSettings(
                use_envmap=envmap is not None,
                use_texture=texture is not None,
                has_media=has_media,
                has_bssrdf=has_bssrdf,
            )
            # The JAX package derives its packet shape here from the
            # workload class (media / BSSRDF scenes, and streams over its
            # SMEM table budget); copied so that one settings object
            # describes a render in both packages. The port's traversal
            # returns the same result for every packet shape.
            from ..ops.traverse_packet import table_fits_smem
            if has_media or has_bssrdf:
                settings = dataclasses.replace(
                    settings, packet_tile_sub=32, packet_interleave=4)
            if not table_fits_smem(flat_bvh.prims.shape[0]):
                settings = dataclasses.replace(
                    settings, packet_tile_sub=16, packet_interleave=4)
        if settings.integrator == "bounce":
            raise NotImplementedError(
                "integrator='bounce' is not ported yet (ROADMAP A10)")
        if settings.integrator != "regen":
            raise ValueError("unknown integrator %r" % (settings.integrator,))
        # the stack only needs the tree's actual depth
        settings = dataclasses.replace(
            settings, stack_depth=min(settings.stack_depth,
                                      int(flat_bvh.max_depth) + 2))
        self.settings = settings
        self._lane_px, self._lane_py = lane_tables(self.width, self.height)
        self.scene = to_device(
            build_scene(flat_bvh, mat_arrays, envmap, texture, settings,
                        env_const, self._lane_px, self._lane_py),
            self.device)

    def zeros_accum(self):
        return torch.zeros((self.width * self.height, 3), dtype=torch.float32,
                           device=self.device)

    def render_frame(self, accum, camera: RenderCamera, frame_number: int):
        """One progressive sample per pixel; frame_number starts at 1."""
        return self.render_frames(accum, camera, frame_number, 1)

    def render_frames(self, accum, camera: RenderCamera, frame_start: int,
                      n_frames: int, with_stats=False):
        """Add n_frames samples per pixel (frames frame_start ..
        frame_start + n_frames - 1) to the lane-ordered accum and return the
        new accum. with_stats=True returns (accum, waves, traced_rays)."""
        from .regen import make_regen_integrator
        fn = make_regen_integrator(self.settings, self.width, self.height,
                                   with_stats=with_stats)
        cam_vec = torch.as_tensor(camera.as_array(), device=self.device)
        out = fn(self.scene, cam_vec, int(frame_start), 0, accum,
                 int(n_frames))
        return out if with_stats else out[0]

    def accum_to_buffer(self, accum):
        """Un-swizzle the lane-ordered accumulation into an [H,W,3] buffer."""
        if isinstance(accum, torch.Tensor):
            accum = accum.detach().cpu().numpy()
        a = np.asarray(accum)[:self.width * self.height]
        img = np.zeros((self.height, self.width, 3), np.float32)
        img[self._lane_py, self._lane_px] = a
        return img

    def accum_to_image(self, accum, frame_count):
        """Tonemap the lane-ordered accumulation into [H,W,3] uint8."""
        from ..core.image import tonemap
        return tonemap(self.accum_to_buffer(accum), frame_count)
