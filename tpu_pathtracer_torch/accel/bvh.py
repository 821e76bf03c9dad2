"""SBVH (spatial-split BVH) builder, host-side.

Implements the Stich-2009 SBVH algorithm with the same decision structure as
the reference builder (src/SplitBVHBuilder.cpp): SAH object splits via
3-axis sort + sweep, SAH spatial splits via 32 chopped bins with enter/exit
counts, per-reference duplicate-or-unsplit decisions, and triangle-plane
reference splitting. Constants match src/SplitBVHBuilder.h:34-39 (MaxDepth 64,
MaxSpatialDepth 48, NumSpatialBins 32) and BVH.h:67-80 (splitAlpha 1e-5).

The implementation is original, array-oriented numpy (reference-stack slices
are vectorized instead of element-wise C++ loops).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

MAX_DEPTH = 64
MAX_SPATIAL_DEPTH = 48
NUM_SPATIAL_BINS = 32
F32_MAX = np.float32(3.402823466e38)


@dataclasses.dataclass
class Platform:
    """SAH cost model (reference src/Util.h:72-110, defaults from the default
    Platform ctor)."""
    sah_node_cost: float = 1.0
    sah_triangle_cost: float = 1.0
    node_batch_size: int = 1
    tri_batch_size: int = 1
    min_leaf_size: int = 1
    max_leaf_size: int = 0x7FFFFFF

    def triangle_cost(self, n):
        nb = -(-np.asarray(n) // self.tri_batch_size) * self.tri_batch_size
        return nb * self.sah_triangle_cost

    def node_cost(self, n):
        nb = -(-n // self.node_batch_size) * self.node_batch_size
        return nb * self.sah_node_cost


@dataclasses.dataclass
class BuildParams:
    split_alpha: float = 1e-5
    enable_spatial_splits: bool = True
    enable_prints: bool = False


class BVHNode:
    __slots__ = ("lo", "hi", "left", "right", "tri_start", "tri_end")

    def __init__(self, lo, hi, left=None, right=None, tri_start=-1, tri_end=-1):
        self.lo = lo
        self.hi = hi
        self.left = left
        self.right = right
        self.tri_start = tri_start
        self.tri_end = tri_end

    @property
    def is_leaf(self):
        return self.left is None

    def area(self):
        d = np.maximum(self.hi - self.lo, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def num_nodes(self):
        if self.is_leaf:
            return 1
        return 1 + self.left.num_nodes() + self.right.num_nodes()

    def max_depth(self, d=0):
        if self.is_leaf:
            return d
        return max(self.left.max_depth(d + 1), self.right.max_depth(d + 1))

    def sah_cost(self, platform: Platform, root_area=None):
        if root_area is None:
            root_area = max(self.area(), 1e-30)
        if self.is_leaf:
            return self.area() / root_area * platform.triangle_cost(self.tri_end - self.tri_start)
        return (self.area() / root_area * platform.node_cost(2)
                + self.left.sah_cost(platform, root_area)
                + self.right.sah_cost(platform, root_area))


def _aabb_area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    if d.ndim == 1:
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


class _RefStack:
    """Growable SoA reference stack: triangle index + AABB per reference."""

    def __init__(self, tri, lo, hi):
        cap = max(16, len(tri) * 2)
        self.tri = np.empty(cap, np.int64)
        self.lo = np.empty((cap, 3), np.float64)
        self.hi = np.empty((cap, 3), np.float64)
        n = len(tri)
        self.tri[:n] = tri
        self.lo[:n] = lo
        self.hi[:n] = hi
        self.size = n

    def _ensure(self, extra):
        need = self.size + extra
        if need > len(self.tri):
            cap = max(need, len(self.tri) * 2)
            self.tri = np.resize(self.tri, cap)
            self.lo = np.resize(self.lo, (cap, 3))
            self.hi = np.resize(self.hi, (cap, 3))

    def append(self, tri, lo, hi):
        self._ensure(1)
        self.tri[self.size] = tri
        self.lo[self.size] = lo
        self.hi[self.size] = hi
        self.size += 1


class SBVHBuilder:
    def __init__(self, tri_verts: np.ndarray, platform: Optional[Platform] = None,
                 params: Optional[BuildParams] = None):
        """tri_verts: [T,3,3] world-space triangle corners."""
        self.tv = np.asarray(tri_verts, np.float64)
        self.platform = platform or Platform()
        self.params = params or BuildParams()
        self.num_duplicates = 0
        self.tri_indices: list[int] = []

    def build(self) -> BVHNode:
        T = self.tv.shape[0]
        lo = self.tv.min(axis=1)
        hi = self.tv.max(axis=1)
        self.refs = _RefStack(np.arange(T), lo, hi)
        root_lo = lo.min(axis=0)
        root_hi = hi.max(axis=0)
        self.min_overlap = _aabb_area(root_lo, root_hi) * self.params.split_alpha
        root = self._build_node(root_lo, root_hi, T, 0)
        self.tri_index_array = np.array(self.tri_indices, np.int64)
        if self.params.enable_prints:
            print("SBVHBuilder: duplicates %.0f%%"
                  % (100.0 * self.num_duplicates / max(T, 1)))
        return root

    # ------------------------------------------------------------------
    def _segment(self, num_ref):
        s = self.refs.size
        return slice(s - num_ref, s)

    def _build_node(self, lo, hi, num_ref, level) -> BVHNode:
        if num_ref <= self.platform.min_leaf_size or level >= MAX_DEPTH:
            return self._create_leaf(lo, hi, num_ref)

        area = _aabb_area(lo, hi)
        leaf_sah = area * self.platform.triangle_cost(num_ref)
        node_sah = area * self.platform.node_cost(2)
        obj = self._find_object_split(num_ref, node_sah)

        spatial = None
        if self.params.enable_spatial_splits and level < MAX_SPATIAL_DEPTH and obj is not None:
            ov_lo = np.maximum(obj["left_lo"], obj["right_lo"])
            ov_hi = np.minimum(obj["left_hi"], obj["right_hi"])
            if np.all(ov_hi >= ov_lo) and _aabb_area(ov_lo, ov_hi) >= self.min_overlap:
                spatial = self._find_spatial_split(lo, hi, num_ref, node_sah)

        obj_sah = obj["sah"] if obj is not None else F32_MAX
        spa_sah = spatial["sah"] if spatial is not None else F32_MAX
        min_sah = min(leaf_sah, obj_sah, spa_sah)

        if min_sah == leaf_sah and num_ref <= self.platform.max_leaf_size:
            return self._create_leaf(lo, hi, num_ref)

        left_spec = right_spec = None
        if spatial is not None and min_sah == spa_sah:
            left_spec, right_spec = self._perform_spatial_split(num_ref, spatial)
        if left_spec is None or left_spec[2] == 0 or right_spec[2] == 0:
            left_spec, right_spec = self._perform_object_split(num_ref, obj)

        self.num_duplicates += left_spec[2] + right_spec[2] - num_ref
        # recurse right first: right refs live at the stack tail (reference
        # recurses rightNode first for the same reason, SplitBVHBuilder.cpp:180)
        right_node = self._build_node(right_spec[0], right_spec[1], right_spec[2], level + 1)
        left_node = self._build_node(left_spec[0], left_spec[1], left_spec[2], level + 1)
        return BVHNode(np.asarray(lo), np.asarray(hi), left_node, right_node)

    def _create_leaf(self, lo, hi, num_ref) -> BVHNode:
        seg = self._segment(num_ref)
        # reference pops refs one by one (removeLast) -> reversed order
        tris = self.refs.tri[seg][::-1].tolist()
        start = len(self.tri_indices)
        self.tri_indices.extend(int(t) for t in tris)
        self.refs.size -= num_ref
        return BVHNode(np.asarray(lo), np.asarray(hi),
                       tri_start=start, tri_end=start + num_ref)

    # ------------------------------------------------------------------
    def _sort_segment(self, num_ref, dim):
        seg = self._segment(num_ref)
        cent = self.refs.lo[seg][:, dim] + self.refs.hi[seg][:, dim]
        order = np.lexsort((self.refs.tri[seg], cent))
        self.refs.tri[seg] = self.refs.tri[seg][order]
        self.refs.lo[seg] = self.refs.lo[seg][order]
        self.refs.hi[seg] = self.refs.hi[seg][order]

    def _find_object_split(self, num_ref, node_sah):
        if num_ref < 2:
            return None
        best = {"sah": F32_MAX, "dim": -1, "num_left": -1}
        seg = self._segment(num_ref)
        for dim in range(3):
            self._sort_segment(num_ref, dim)
            lo = self.refs.lo[seg]
            hi = self.refs.hi[seg]
            # prefix bounds left->right, suffix bounds right->left (vectorized
            # version of the reference's two sweeps)
            pre_lo = np.minimum.accumulate(lo, axis=0)
            pre_hi = np.maximum.accumulate(hi, axis=0)
            suf_lo = np.minimum.accumulate(lo[::-1], axis=0)[::-1]
            suf_hi = np.maximum.accumulate(hi[::-1], axis=0)[::-1]
            i = np.arange(1, num_ref)
            left_area = _aabb_area(pre_lo[:-1], pre_hi[:-1])
            right_area = _aabb_area(suf_lo[1:], suf_hi[1:])
            sah = (node_sah
                   + left_area * self.platform.triangle_cost(i)
                   + right_area * self.platform.triangle_cost(num_ref - i))
            k = int(np.argmin(sah))
            if sah[k] < best["sah"]:
                best = {
                    "sah": float(sah[k]), "dim": dim, "num_left": int(i[k]),
                    "left_lo": pre_lo[k].copy(), "left_hi": pre_hi[k].copy(),
                    "right_lo": suf_lo[k + 1].copy(), "right_hi": suf_hi[k + 1].copy(),
                }
        if best["dim"] < 0:
            return None
        return best

    def _perform_object_split(self, num_ref, obj):
        self._sort_segment(num_ref, obj["dim"])
        nl = obj["num_left"]
        left = (obj["left_lo"], obj["left_hi"], nl)
        right = (obj["right_lo"], obj["right_hi"], num_ref - nl)
        return left, right

    # ------------------------------------------------------------------
    def _find_spatial_split(self, lo, hi, num_ref, node_sah):
        origin = np.asarray(lo, np.float64)
        bin_size = (np.asarray(hi, np.float64) - origin) / NUM_SPATIAL_BINS
        safe = np.where(bin_size > 0, bin_size, 1.0)
        inv_bin = 1.0 / safe

        seg = self._segment(num_ref)
        rlo = self.refs.lo[seg]
        rhi = self.refs.hi[seg]
        rtri = self.refs.tri[seg]

        first_bin = np.clip(((rlo - origin) * inv_bin).astype(np.int64), 0, NUM_SPATIAL_BINS - 1)
        last_bin = np.clip(((rhi - origin) * inv_bin).astype(np.int64), first_bin, NUM_SPATIAL_BINS - 1)

        bins_lo = np.full((3, NUM_SPATIAL_BINS, 3), F32_MAX, np.float64)
        bins_hi = np.full((3, NUM_SPATIAL_BINS, 3), -F32_MAX, np.float64)
        enter = np.zeros((3, NUM_SPATIAL_BINS), np.int64)
        exit_ = np.zeros((3, NUM_SPATIAL_BINS), np.int64)

        for dim in range(3):
            np.add.at(enter[dim], first_bin[:, dim], 1)
            np.add.at(exit_[dim], last_bin[:, dim], 1)
            spans = last_bin[:, dim] - first_bin[:, dim]
            simple = spans == 0
            # references fully inside one bin: vector scatter-min/max
            if np.any(simple):
                b = first_bin[simple, dim]
                np.minimum.at(bins_lo[dim], b, rlo[simple])
                np.maximum.at(bins_hi[dim], b, rhi[simple])
            # straddling references: chop triangle against bin planes
            for ri in np.nonzero(~simple)[0]:
                cur_lo = rlo[ri].copy()
                cur_hi = rhi[ri].copy()
                tri = int(rtri[ri])
                for b in range(int(first_bin[ri, dim]), int(last_bin[ri, dim])):
                    pos = origin[dim] + bin_size[dim] * (b + 1)
                    (llo, lhi), (nlo, nhi) = self._split_reference(
                        tri, cur_lo, cur_hi, dim, pos)
                    bins_lo[dim, b] = np.minimum(bins_lo[dim, b], llo)
                    bins_hi[dim, b] = np.maximum(bins_hi[dim, b], lhi)
                    cur_lo, cur_hi = nlo, nhi
                b = int(last_bin[ri, dim])
                bins_lo[dim, b] = np.minimum(bins_lo[dim, b], cur_lo)
                bins_hi[dim, b] = np.maximum(bins_hi[dim, b], cur_hi)

        best = {"sah": F32_MAX, "dim": -1, "pos": 0.0}
        for dim in range(3):
            if bin_size[dim] <= 0:
                continue
            pre_lo = np.minimum.accumulate(bins_lo[dim], axis=0)
            pre_hi = np.maximum.accumulate(bins_hi[dim], axis=0)
            suf_lo = np.minimum.accumulate(bins_lo[dim][::-1], axis=0)[::-1]
            suf_hi = np.maximum.accumulate(bins_hi[dim][::-1], axis=0)[::-1]
            left_num = np.cumsum(enter[dim])[:-1]
            right_num = num_ref - np.cumsum(exit_[dim])[:-1]
            la = _aabb_area(pre_lo[:-1], pre_hi[:-1])
            ra = _aabb_area(suf_lo[1:], suf_hi[1:])
            sah = (node_sah
                   + la * self.platform.triangle_cost(left_num)
                   + ra * self.platform.triangle_cost(right_num))
            k = int(np.argmin(sah))
            if sah[k] < best["sah"]:
                best = {"sah": float(sah[k]), "dim": dim,
                        "pos": float(origin[dim] + bin_size[dim] * (k + 1))}
        if best["dim"] < 0:
            return None
        return best

    def _split_reference(self, tri, ref_lo, ref_hi, dim, pos):
        """Clip triangle `tri`'s reference AABB by plane dim=pos; returns
        ((left_lo, left_hi), (right_lo, right_hi)). Mirrors splitReference
        (SplitBVHBuilder.cpp:442-485)."""
        verts = self.tv[tri]  # [3,3]
        INF = np.float64(F32_MAX)
        llo = np.full(3, INF)
        lhi = np.full(3, -INF)
        rlo = np.full(3, INF)
        rhi = np.full(3, -INF)
        v1 = verts[2]
        for i in range(3):
            v0 = v1
            v1 = verts[i]
            v0p, v1p = v0[dim], v1[dim]
            if v0p <= pos:
                llo = np.minimum(llo, v0)
                lhi = np.maximum(lhi, v0)
            if v0p >= pos:
                rlo = np.minimum(rlo, v0)
                rhi = np.maximum(rhi, v0)
            if (v0p < pos < v1p) or (v1p < pos < v0p):
                t = np.clip((pos - v0p) / (v1p - v0p), 0.0, 1.0)
                x = v0 + (v1 - v0) * t
                llo = np.minimum(llo, x)
                lhi = np.maximum(lhi, x)
                rlo = np.minimum(rlo, x)
                rhi = np.maximum(rhi, x)
        lhi[dim] = pos
        rlo[dim] = pos
        # intersect with original reference bounds
        llo = np.maximum(llo, ref_lo)
        lhi = np.minimum(lhi, ref_hi)
        rlo = np.maximum(rlo, ref_lo)
        rhi = np.minimum(rhi, ref_hi)
        return (llo, lhi), (rlo, rhi)

    def _perform_spatial_split(self, num_ref, split):
        """Mirrors performSpatialSplit (SplitBVHBuilder.cpp:346-438):
        partition tail refs into left/straddle/right, then resolve straddlers
        by unsplit-left / unsplit-right / duplicate SAH choice."""
        refs = self.refs
        dim, pos = split["dim"], split["pos"]
        left_start = refs.size - num_ref

        seg = slice(left_start, refs.size)
        tri = refs.tri[seg].copy()
        lo = refs.lo[seg].copy()
        hi = refs.hi[seg].copy()

        on_left = hi[:, dim] <= pos
        on_right = lo[:, dim] >= pos
        straddle = ~(on_left | on_right)

        INF = np.float64(F32_MAX)

        def bounds_of(mask):
            if not np.any(mask):
                return np.full(3, INF), np.full(3, -INF)
            return lo[mask].min(axis=0), hi[mask].max(axis=0)

        left_lo, left_hi = bounds_of(on_left)
        right_lo, right_hi = bounds_of(on_right)

        left_list = [(tri[i], lo[i], hi[i]) for i in np.nonzero(on_left)[0]]
        right_list = [(tri[i], lo[i], hi[i]) for i in np.nonzero(on_right)[0]]

        def area2(alo, ahi):
            if np.any(ahi < alo):
                return 0.0
            return _aabb_area(alo, ahi)

        tc = self.platform.triangle_cost
        for i in np.nonzero(straddle)[0]:
            (llo, lhi), (rlo, rhi) = self._split_reference(int(tri[i]), lo[i], hi[i], dim, pos)
            lub_lo = np.minimum(left_lo, lo[i]); lub_hi = np.maximum(left_hi, hi[i])
            rub_lo = np.minimum(right_lo, lo[i]); rub_hi = np.maximum(right_hi, hi[i])
            ldb_lo = np.minimum(left_lo, llo); ldb_hi = np.maximum(left_hi, lhi)
            rdb_lo = np.minimum(right_lo, rlo); rdb_hi = np.maximum(right_hi, rhi)

            lac = tc(len(left_list))
            rac = tc(len(right_list))
            lbc = tc(len(left_list) + 1)
            rbc = tc(len(right_list) + 1)

            unsplit_left = area2(lub_lo, lub_hi) * lbc + area2(right_lo, right_hi) * rac
            unsplit_right = area2(left_lo, left_hi) * lac + area2(rub_lo, rub_hi) * rbc
            duplicate = area2(ldb_lo, ldb_hi) * lbc + area2(rdb_lo, rdb_hi) * rbc
            m = min(unsplit_left, unsplit_right, duplicate)
            if m == unsplit_left:
                left_lo, left_hi = lub_lo, lub_hi
                left_list.append((tri[i], lo[i], hi[i]))
            elif m == unsplit_right:
                right_lo, right_hi = rub_lo, rub_hi
                right_list.append((tri[i], lo[i], hi[i]))
            else:
                left_lo, left_hi = ldb_lo, ldb_hi
                right_lo, right_hi = rdb_lo, rdb_hi
                left_list.append((tri[i], llo, lhi))
                right_list.append((tri[i], rlo, rhi))

        if not left_list or not right_list:
            return (None, None, 0), (None, None, 0)

        # rewrite the stack tail: [left refs][right refs] with right at the top
        new_n = len(left_list) + len(right_list)
        refs.size = left_start
        refs._ensure(new_n)
        for t, alo, ahi in left_list + right_list:
            refs.tri[refs.size] = t
            refs.lo[refs.size] = alo
            refs.hi[refs.size] = ahi
            refs.size += 1
        return ((left_lo, left_hi, len(left_list)),
                (right_lo, right_hi, len(right_list)))


def build_bvh(tri_verts, platform=None, params=None):
    """Convenience: build and return (root, tri_index_array, builder)."""
    b = SBVHBuilder(tri_verts, platform, params)
    root = b.build()
    return root, b.tri_index_array, b


# ---------------------------------------------------------------------------
# validation helpers (used by tests)

def validate_bvh(root: BVHNode, tri_indices, num_tris, check_coverage=True):
    """Invariants: child bounds nest in parent, leaf ranges tile tri_indices,
    and (object-split-only builds) every triangle is referenced exactly once."""
    seen = []

    def rec(node, plo, phi):
        assert np.all(node.lo >= plo - 1e-5) and np.all(node.hi <= phi + 1e-5), \
            "child bounds must nest inside parent"
        if node.is_leaf:
            assert 0 <= node.tri_start < node.tri_end <= len(tri_indices)
            seen.extend(tri_indices[node.tri_start:node.tri_end])
        else:
            rec(node.left, node.lo, node.hi)
            rec(node.right, node.lo, node.hi)

    rec(root, root.lo, root.hi)
    assert len(seen) == len(tri_indices)
    if check_coverage:
        assert set(int(s) for s in seen) == set(range(num_tris)), \
            "every triangle must be referenced"
    return True
