"""The reference's closest-hit and any-hit search, independent of the
program's SBVH: a balanced bounding-volume tree over the original
triangles (median splits on the longest axis, LEAF triangles a leaf, the
leaves padded to a power of two under an implicit complete binary tree) and a
Moller-Trumbore triangle test. Plain numpy for the build, plain torch for
the search, vectorized over rays: each ray walks the tree near child
first with a stack of its own; rays that finish drop out of the working
set once half of it has.
"""
from __future__ import annotations

import numpy as np
import torch

LEAF = 4
# a trace's last rays at most this many are finished by _brute
BRUTE = 256


def _median_order(cen, n_leaves):
    """Triangle order of a balanced tree: level by level, the triangles of
    each node's slot range sorted along the longest axis of their
    centroids' bounds, so that each child takes half of the range."""
    T = cen.shape[0]
    order = np.arange(T)
    seg = LEAF * n_leaves
    while seg > LEAF:
        node = np.arange(T) // seg
        c = cen[order]
        n_nodes = node[-1] + 1
        lo = np.full((n_nodes, 3), np.inf)
        hi = np.full((n_nodes, 3), -np.inf)
        np.minimum.at(lo, node, c)
        np.maximum.at(hi, node, c)
        axis = np.argmax(hi - lo, axis=1)[node]
        key = c[np.arange(T), axis]
        order = order[np.lexsort((key, node))]
        seg //= 2
    return order


class TriangleTree:
    """The tree of one mesh, on `device` in `dtype`.

    tri_verts [T,3,3]. Nodes are heap-numbered from 1; the leaves are the
    nodes [n_leaves, 2 n_leaves), leaf j holding the triangles
    order[LEAF j : LEAF j + LEAF] (-1 pads)."""

    def __init__(self, tri_verts, device, dtype=torch.float32):
        tv = np.asarray(tri_verts, np.float32)
        T = tv.shape[0]
        n_leaves = 2
        while n_leaves * LEAF < T:
            n_leaves *= 2
        order = _median_order(tv.mean(axis=1).astype(np.float64), n_leaves)
        slots = np.full(n_leaves * LEAF, -1, np.int64)
        slots[:T] = order
        leaf_tris = slots.reshape(n_leaves, LEAF)
        box_lo = np.full((2 * n_leaves, 3), np.inf, np.float32)
        box_hi = np.full((2 * n_leaves, 3), -np.inf, np.float32)
        valid = np.zeros(2 * n_leaves, bool)
        tmin = tv.min(axis=1)
        tmax = tv.max(axis=1)
        safe = np.maximum(leaf_tris, 0)
        used = (leaf_tris >= 0)[..., None]
        box_lo[n_leaves:] = np.where(used, tmin[safe], np.inf).min(axis=1)
        box_hi[n_leaves:] = np.where(used, tmax[safe], -np.inf).max(axis=1)
        valid[n_leaves:] = leaf_tris[:, 0] >= 0
        width = n_leaves
        while width > 1:
            width //= 2
            kids = np.arange(width, 2 * width)
            box_lo[kids] = np.minimum(box_lo[2 * kids], box_lo[2 * kids + 1])
            box_hi[kids] = np.maximum(box_hi[2 * kids], box_hi[2 * kids + 1])
            valid[kids] = valid[2 * kids] | valid[2 * kids + 1]
        box_lo[~valid] = 0.0
        box_hi[~valid] = 0.0
        self.n_leaves = n_leaves
        self.depth = int(np.log2(n_leaves))
        f = dict(device=device, dtype=dtype)
        # node i's children 2i, 2i+1: their boxes side by side, [lo | hi]
        kids = np.concatenate([box_lo, box_hi], axis=1).reshape(-1, 2, 6)
        self.kid_boxes = torch.as_tensor(kids, **f)          # [n_leaves, 2, 6]
        self.kid_valid = torch.as_tensor(valid.reshape(-1, 2), device=device)
        self.leaf_tris = torch.as_tensor(leaf_tris, device=device)
        # each triangle as (v0, v1 - v0, v2 - v0)
        edges = np.concatenate([tv[:, 0], tv[:, 1] - tv[:, 0],
                                tv[:, 2] - tv[:, 0]], axis=1)
        self.tris = torch.as_tensor(edges, **f)              # [T, 9]
        self.device, self.dtype = device, dtype

    def _kids(self, node, o, inv, tn, tf):
        """Entry distances [n,2] of each ray into the boxes of the two
        children of its inner node, +inf where missed."""
        bx = self.kid_boxes[node]                            # [n,2,6]
        t1 = (bx[..., :3] - o[:, None]) * inv[:, None]
        t2 = (bx[..., 3:] - o[:, None]) * inv[:, None]
        near = torch.maximum(torch.minimum(t1, t2).amax(dim=2), tn[:, None])
        far = torch.minimum(torch.maximum(t1, t2).amin(dim=2), tf[:, None])
        ok = (near <= far) & self.kid_valid[node]
        return torch.where(ok, near, torch.full_like(near, float("inf")))

    @staticmethod
    def _mt(tri, o, d, tn, tf):
        """Moller-Trumbore of rays o, d [n,3] against triangles tri [n,m,9]
        (v0, e1, e2): t [n,m], +inf where missed."""
        v0, e1, e2 = tri[..., 0:3], tri[..., 3:6], tri[..., 6:9]
        dd = d[:, None, :].expand_as(e1)
        p = torch.linalg.cross(dd, e2, dim=-1)
        det = (e1 * p).sum(-1)
        inv_det = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
        s = o[:, None, :] - v0
        u = (s * p).sum(-1) * inv_det
        q = torch.linalg.cross(s, e1, dim=-1)
        w = (dd * q).sum(-1) * inv_det
        t = (e2 * q).sum(-1) * inv_det
        ok = ((det != 0) & (u >= 0) & (w >= 0) & (u + w <= 1)
              & (t > tn[:, None]) & (t < tf[:, None]))
        return torch.where(ok, t, torch.full_like(t, float("inf")))

    def _triangles(self, leaf, o, d, tn, tf):
        """The leaf's LEAF triangles: (t [n,LEAF], tri ids [n,LEAF])."""
        tri = self.leaf_tris[leaf]                           # [n,L]
        t = self._mt(self.tris[torch.clamp_min(tri, 0)], o, d, tn, tf)
        return torch.where(tri >= 0, t, torch.full_like(t, float("inf"))), tri

    def _brute(self, o, d, tn, tf):
        """The closest hit of each ray among all triangles in (tn, tf):
        (tri [n] or -1, t [n]); for an any-hit ray, the closest is a hit.
        For the last few rays of a trace, whose walks would cost more
        launches than this."""
        n, T = o.shape[0], self.tris.shape[0]
        best = torch.full((n,), -1, dtype=torch.int64, device=self.device)
        t_out = tf.clone()
        step = max(1, (1 << 24) // T)
        for a in range(0, n, step):
            b = min(a + step, n)
            t = self._mt(self.tris[None].expand(b - a, T, 9), o[a:b],
                         d[a:b], tn[a:b], tf[a:b])
            tb, k = t.min(dim=1)
            hit = torch.isfinite(tb)
            t_out[a:b] = torch.where(hit, tb, tf[a:b])
            best[a:b] = torch.where(hit, k, best[a:b])
        return best, t_out

    def trace(self, orig, raydir, tmin, tmax, anyhit=False):
        """orig, raydir [R,3]; tmin a float; tmax a float or [R]. Returns
        (tri [R] int64: the closest hit's triangle or -1, t [R]: its
        distance, tmax where nothing is hit). With anyhit a ray stops at
        its first hit (tri is then some hit triangle)."""
        dev, dt = self.device, self.dtype
        R = orig.shape[0]
        o_all = orig.to(dt)
        d_all = raydir.to(dt)
        t_out = torch.as_tensor(tmax, device=dev, dtype=dt).expand(R).clone()
        tri_out = torch.full((R,), -1, dtype=torch.int64, device=dev)
        if R == 0:
            return tri_out, t_out
        eps = 2.0 ** -80
        d_safe = torch.where(
            d_all.abs() > eps, d_all,
            torch.where(d_all >= 0, torch.full_like(d_all, eps),
                        torch.full_like(d_all, -eps)))
        lanes = torch.arange(R, device=dev)
        o, d, inv = o_all, d_all, 1.0 / d_safe
        tn = torch.full((R,), float(tmin), device=dev, dtype=dt)
        tf = t_out.clone()
        best = tri_out.clone()
        S = 2 * self.depth + 4
        stack = torch.zeros((R, S), dtype=torch.int64, device=dev)
        sp = torch.zeros((R,), dtype=torch.int64, device=dev)
        cur = torch.ones((R,), dtype=torch.int64, device=dev)  # the root
        done = torch.zeros((R,), dtype=torch.bool, device=dev)
        nl = self.n_leaves
        n = R
        while True:
            if n <= BRUTE:
                bt, btt = self._brute(o, d, tn, tf)
                hitb = bt >= 0
                t_out[lanes] = torch.where(hitb, btt, tf)
                tri_out[lanes] = torch.where(hitb, bt, best)
                return tri_out, t_out
            leaf = cur >= nl
            # ---- inner node: both children's boxes ----
            tk = self._kids(torch.where(leaf, 0, cur), o, inv, tn, tf)
            t0, t1 = tk[:, 0], tk[:, 1]
            c0 = 2 * cur
            c1 = c0 + 1
            h0 = torch.isfinite(t0) & ~leaf
            h1 = torch.isfinite(t1) & ~leaf
            swap = h0 & h1 & (t1 < t0)
            near = torch.where(swap, c1, torch.where(h0, c0, c1))
            far = torch.where(swap, c0, c1)
            push = h0 & h1
            # ---- leaf: its triangles ----
            lt, ltri = self._triangles(torch.where(leaf, cur - nl, 0), o, d,
                                       tn, tf)
            tbest, k = lt.min(dim=1)
            hit = leaf & torch.isfinite(tbest)
            tf = torch.where(hit, tbest, tf)
            best = torch.where(hit, ltri.gather(1, k[:, None])[:, 0], best)
            # ---- next node: the near child, else pop ----
            pop = (leaf | ~(h0 | h1))
            top = stack.gather(1, torch.clamp_min(sp - 1, 0)[:, None])[:, 0]
            empty = pop & (sp == 0)
            nxt = torch.where(pop, top, near)
            sp = torch.where(pop & ~empty, sp - 1, sp)
            stack.scatter_(1, torch.where(push, sp, S - 1)[:, None],
                           far[:, None])
            sp = sp + push.to(torch.int64)
            fin = empty | (hit if anyhit else torch.zeros_like(hit))
            done = done | fin
            cur = torch.where(fin, cur, nxt)
            n_done = int(done.sum())
            if n_done * 2 >= n or n_done == n:
                t_out[lanes[done]] = tf[done]
                tri_out[lanes[done]] = best[done]
                keep = ~done
                n = n - n_done
                if n == 0:
                    return tri_out, t_out
                (lanes, o, d, inv, tn, tf, best, stack, sp, cur) = (
                    x[keep] for x in (lanes, o, d, inv, tn, tf, best, stack,
                                      sp, cur))
                done = torch.zeros((n,), dtype=torch.bool, device=dev)
