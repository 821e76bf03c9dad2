"""BVH traversal + Woop triangle intersection in plain PyTorch (port of
tracer/traverse.py).

`intersect_scene` is the plain version of the CUDA traversal kernel
(`ops/traverse_packet.py`, `csrc/traverse.cu`): the same per-lane step
machine as the JAX reference. Each step a lane reads one row of the packed
(K,16) stream and either runs the two child slab tests of a node row or
the Woop test of a triangle row, chosen by the sign of its cursor.

Layout of the stream (`accel/flatten.py`): a node row holds
the two child boxes in cols 0:12 and the children in meta cols 12:14 (an
inner child is its row, a leaf child is ~(first triangle row)); a triangle
row holds the Woop matrix in cols 0:12 and (attribute slot, is-last) in
meta. Meta columns are int32 bit patterns stored in f32 slots.

Differences in schedule from the JAX version, none in result:
* the traversal stack is a per-lane (n, depth+1) table indexed by a stack
  pointer (the extra column absorbs the writes of lanes that do not push);
* lanes that finish drop out of the working set once half of it is done,
  so a trace costs about the work of its slowest lanes, not N times it.
A push onto a full stack is dropped; the Renderer sizes the stack from the
tree's depth, so this never happens for its scenes.
"""
from __future__ import annotations

import numpy as np
import torch

SENTINEL = 0x76543210  # same sentinel as src/renderkernel.cu:42
STACK_DEPTH = 64

# slab columns: node row cols 0:12 are [c0.lo.x, c0.hi.x, c0.lo.y, c0.hi.y,
# c1.lo.x, c1.hi.x, c1.lo.y, c1.hi.y, c0.lo.z, c0.hi.z, c1.lo.z, c1.hi.z]
_SLAB_AXIS = [0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 2, 2]


def _ray_precompute(raydir):
    """ooeps-guarded inverse direction (src/renderkernel.cu:189-192)."""
    ooeps = 2.0 ** -80
    d = torch.where(torch.abs(raydir) > ooeps, raydir,
                    torch.where(raydir >= 0, ooeps, -ooeps))
    return 1.0 / d


def pack_stream(prims, meta):
    """Pack (K,12) f32 prim rows and (K,2) i32 meta into one (K,16) f32
    array, meta bit patterns in cols 12:14, cols 14:16 zero (numpy)."""
    K = prims.shape[0]
    packed = np.zeros((K, 16), np.float32)
    packed[:, :12] = np.asarray(prims, np.float32)
    packed[:, 12:14] = np.asarray(meta, np.int32).view(np.float32)
    return packed


def _lane_vector(x, n, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device) \
        .expand(n).contiguous()


def intersect_scene(prims, meta, num_nodes, orig, raydir, tmin, tmax,
                    anyhit=False, stack_depth=STACK_DEPTH, active=None,
                    packed=None, count_steps=False):
    """Trace rays against the flattened BVH.

    prims [K,12] f32 and meta [K,2] i32, or `packed` [K,16] from
    pack_stream. orig, raydir: [N,3] f32; tmin, tmax: scalar or [N];
    active: optional [N] bool. Returns (hit_slot [N] i32, the attribute slot
    of the closest hit or -1, and hit_t [N] f32, tmax where nothing was
    hit). With anyhit=True a lane stops at its first accepted hit.
    Inactive lanes return (-1, tmax).

    count_steps=True adds a third output, steps [N] i32: the number of
    steps in which the lane's cursor was not SENTINEL, i.e. the rows it
    fetched (0 for inactive lanes)."""
    device = orig.device
    N = orig.shape[0]
    if packed is None:
        K = prims.shape[0]
        packed = torch.cat([
            prims.to(torch.float32),
            meta.to(torch.int32).contiguous().view(torch.float32),
            torch.zeros((K, 2), dtype=torch.float32, device=device)], dim=1)
    tmin_a = _lane_vector(tmin, N, device)
    hit_t = _lane_vector(tmax, N, device).clone()
    hit_slot = torch.full((N,), -1, dtype=torch.int32, device=device)
    steps = torch.zeros((N,), dtype=torch.int32, device=device) \
        if count_steps else None

    def result():
        return (hit_slot, hit_t, steps) if count_steps else (hit_slot, hit_t)

    if active is None:
        lanes = torch.arange(N, device=device)
    else:
        lanes = torch.nonzero(active.reshape(N)).reshape(-1)
    n = lanes.shape[0]
    if n == 0:
        return result()

    o = orig[lanes].to(torch.float32)
    d = raydir[lanes].to(torch.float32)
    idir = _ray_precompute(d)
    ood = o * idir
    idir12 = idir[:, _SLAB_AXIS]
    ood12 = ood[:, _SLAB_AXIS]
    tn = tmin_a[lanes]
    ht = hit_t[lanes]
    hs = hit_slot[lanes]
    cur = torch.zeros((n,), dtype=torch.int32, device=device)
    S = int(stack_depth)
    stack = torch.full((n, S + 1), SENTINEL, dtype=torch.int32, device=device)
    sp = torch.zeros((n,), dtype=torch.int64, device=device)
    cnt = torch.zeros((n,), dtype=torch.int32, device=device)

    while True:
        alive = cur != SENTINEL
        if count_steps:
            cnt = cnt + alive.to(torch.int32)
        is_node = alive & (cur >= 0)
        is_tri = cur < 0
        row = torch.where(is_tri, ~cur, torch.where(is_node, cur, 0))
        pm = packed[row.long()]                       # the ONE row gather
        p = pm[:, :12]
        md = pm[:, 12:14].contiguous().view(torch.int32)
        child0, child1 = md[:, 0], md[:, 1]

        # ---- node work: two slab tests ----
        c = p * idir12 - ood12
        lo = torch.minimum(c[:, 0::2], c[:, 1::2])   # c0x c0y c1x c1y c0z c1z
        hi = torch.maximum(c[:, 0::2], c[:, 1::2])
        c0min = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]),
                              torch.maximum(lo[:, 4], tn))
        c0max = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]),
                              torch.minimum(hi[:, 4], ht))
        c1min = torch.maximum(torch.maximum(lo[:, 2], lo[:, 3]),
                              torch.maximum(lo[:, 5], tn))
        c1max = torch.minimum(torch.minimum(hi[:, 2], hi[:, 3]),
                              torch.minimum(hi[:, 5], ht))
        trav0 = c0min <= c0max
        trav1 = c1min <= c1max
        both = trav0 & trav1
        swap = both & (c1min < c0min)
        near = torch.where(swap, child1, child0)
        far = torch.where(swap, child0, child1)
        node_next = torch.where(both, near, torch.where(trav0, child0, child1))
        node_push = is_node & both
        node_pop = is_node & ~trav0 & ~trav1

        # ---- triangle work: Woop unit-triangle test ----
        # Oz = m0w - o.m0, Ox = m1w + o.m1, Oy = m2w + o.m2, each summed
        # left to right; -((-a + b) + c) == (a - b) - c exactly.
        m = p.view(-1, 3, 4)
        om = o[:, None, :] * m[:, :, :3]
        dm = d[:, None, :] * m[:, :, :3]
        base = torch.stack([-m[:, 0, 3], m[:, 1, 3], m[:, 2, 3]], dim=1)
        ov = ((base + om[:, :, 0]) + om[:, :, 1]) + om[:, :, 2]
        dv = (dm[:, :, 0] + dm[:, :, 1]) + dm[:, :, 2]
        t = -ov[:, 0] * (1.0 / dv[:, 0])
        u = ov[:, 1] + t * dv[:, 1]
        v = ov[:, 2] + t * dv[:, 2]
        tri_hit = (is_tri & (t > tn) & (t < ht) & (u >= 0.0) & (u <= 1.0)
                   & (v >= 0.0) & (u + v <= 1.0))
        ht = torch.where(tri_hit, t, ht)
        hs = torch.where(tri_hit, child0, hs)
        tri_stop = is_tri & (child1 != 0)
        if anyhit:
            tri_stop = tri_stop | tri_hit

        # ---- stack: pop for exhausted nodes / finished leaf runs, push the
        # far child when both children are entered ----
        need_pop = node_pop | tri_stop
        if anyhit:
            need_pop = need_pop & ~tri_hit
        top = stack.gather(1, (sp - 1).clamp_min(0)[:, None])[:, 0]
        popped = torch.where(sp > 0, top, SENTINEL)
        new_cur = torch.where(
            is_node, torch.where(node_pop, popped, node_next),
            torch.where(is_tri, torch.where(tri_stop, popped, cur - 1), cur))
        if anyhit:
            new_cur = torch.where(tri_hit, SENTINEL, new_cur)
        sp = torch.where(need_pop, (sp - 1).clamp_min(0), sp)
        push = node_push & (sp < S)
        stack.scatter_(1, torch.where(push, sp, S)[:, None], far[:, None])
        sp = sp + push.to(torch.int64)
        cur = new_cur

        keep = cur != SENTINEL
        n_keep = int(keep.sum())
        if n_keep * 2 <= n:
            hit_t[lanes] = ht
            hit_slot[lanes] = hs
            if count_steps:
                steps[lanes] = cnt
            if n_keep == 0:
                return result()
            (lanes, o, d, idir12, ood12, tn, ht, hs, cur, stack, sp, cnt) = (
                x[keep] for x in (lanes, o, d, idir12, ood12, tn, ht, hs,
                                  cur, stack, sp, cnt))
            n = n_keep


def woop_geometric_normal(prims, num_nodes, hit_slot):
    """Geometric normal of the hit triangle = cross(m1.xyz, m2.xyz) of its
    Woop row; zeros where hit_slot is -1."""
    row = num_nodes + torch.clamp_min(hit_slot, 0).long()
    p = prims[row]
    n = torch.linalg.cross(p[:, 4:7], p[:, 8:11], dim=-1)
    return torch.where((hit_slot >= 0)[:, None], n, 0.0)


def brute_force_intersect(tri_verts, orig, raydir, tmin, tmax):
    """Test oracle: Moller-Trumbore over all triangles in float64 numpy,
    O(N*T). Returns (hit_tri [N] original triangle index or -1, hit_t [N])."""
    o = np.asarray(orig, np.float64)[:, None, :]
    d = np.asarray(raydir, np.float64)[:, None, :]
    v0 = np.asarray(tri_verts, np.float64)[None, :, 0, :]
    v1 = np.asarray(tri_verts, np.float64)[None, :, 1, :]
    v2 = np.asarray(tri_verts, np.float64)[None, :, 2, :]
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = np.cross(d, e2)
    det = np.sum(e1 * pvec, -1)
    inv_det = np.where(np.abs(det) > 1e-12,
                       1.0 / np.where(det == 0, 1, det), 0.0)
    tvec = o - v0
    u = np.sum(tvec * pvec, -1) * inv_det
    qvec = np.cross(tvec, e1)
    v = np.sum(d * qvec, -1) * inv_det
    t = np.sum(e2 * qvec, -1) * inv_det
    ok = (np.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) \
        & (t > tmin) & (t < tmax)
    t = np.where(ok, t, np.inf)
    best = np.argmin(t, axis=1)
    best_t = t[np.arange(t.shape[0]), best]
    hit = np.isfinite(best_t)
    return np.where(hit, best, -1), np.where(hit, best_t, np.asarray(tmax))
