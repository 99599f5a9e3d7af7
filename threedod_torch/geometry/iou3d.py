"""Exact IoU of oriented 3D boxes by polyhedral clipping (counterpart of
``threedod/geometry/iou3d.py``'s plain form, for pytorch3d's
``box3d_overlap``).

The intersection of two convex boxes A and B is bounded by the faces of A
clipped to B's half-spaces and the faces of B clipped to A's. Each quad face
is clipped by 6 half-planes with Sutherland-Hodgman (a convex polygon cut by
k planes has at most 4 + k vertices, so every buffer has ``MAX_VERTS`` = 10
rows), and the volume follows from the divergence theorem over fan
triangles. Everything is batched over box pairs, in f32, in chunks of
``CHUNK`` pairs, on the boxes' device. Boxes are 8 corners in the layout of
``geometry/cuboids.py``. A pair with a non-finite or a zero-volume box
scores 0.
"""
from __future__ import annotations

from typing import Tuple

import torch

MAX_VERTS = 10  # 4 quad vertices + up to 6 clip planes
CHUNK = 65536  # box pairs per batched clip
# the 6 faces of a box as corner indices, wound outward (the JAX package's
# ``cuboids.QUAD_FACES``)
QUAD_FACES = ((0, 3, 2, 1), (4, 5, 6, 7), (1, 2, 6, 5), (0, 4, 7, 3), (2, 3, 7, 6), (0, 1, 5, 4))


def box_volume(corners: torch.Tensor) -> torch.Tensor:
    """Volume of boxes from corners (..., 8, 3) = |det[e1 e2 e3]|."""
    e1 = corners[..., 1, :] - corners[..., 0, :]
    e2 = corners[..., 3, :] - corners[..., 0, :]
    e3 = corners[..., 4, :] - corners[..., 0, :]
    return (e1 * torch.cross(e2, e3, dim=-1)).sum(-1).abs()


def _faces(corners: torch.Tensor) -> torch.Tensor:
    """(P, 8, 3) corners -> (P, 6, 4, 3) faces, gathered by slices: an index
    tensor copied from the host would wait for the card."""
    return torch.stack([corners[:, i] for face in QUAD_FACES for i in face], 1).reshape(-1, 6, 4, 3)


def _face_planes(corners: torch.Tensor):
    """Outward unit normals (P, 6, 3) and offsets (P, 6) of the faces of boxes
    (P, 8, 3): half-spaces {p : n.p <= d}, oriented outward by a centroid test
    so that a reflected corner order works too."""
    quads = _faces(corners)
    center = corners.mean(1)
    n = torch.cross(quads[:, :, 1] - quads[:, :, 0], quads[:, :, 2] - quads[:, :, 1], dim=-1)
    n = n / n.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    face_centers = quads.mean(2)
    outward = torch.sign((n * (face_centers - center[:, None])).sum(-1, keepdim=True))
    n = n * torch.where(outward == 0, torch.ones_like(outward), outward)
    return n, (n * face_centers).sum(-1)


def _winding_sign(corners: torch.Tensor) -> torch.Tensor:
    """+1 where the face order winds outward for the corners (P, 8, 3), -1
    where inward (corners of a reflected basis)."""
    e1 = corners[:, 1] - corners[:, 0]
    e2 = corners[:, 3] - corners[:, 0]
    e3 = corners[:, 4] - corners[:, 0]
    s = torch.sign((e1 * torch.cross(e2, e3, dim=-1)).sum(-1))
    return torch.where(s == 0, torch.ones_like(s), s)


def _clip(verts, count, n, d, eps):
    """Sutherland-Hodgman clip of convex polygons by half-spaces n.p <= d.

    verts (J, MAX_VERTS, 3) padded, count (J,), n (J, 3), d (J,), eps (J,)
    -> (verts, count), the kept candidates packed in order."""
    m = MAX_VERTS
    idx = torch.arange(m, device=verts.device)
    nxt = torch.where(idx[None] + 1 >= count[:, None], 0, idx[None] + 1)  # (J, m)
    dist = (verts * n[:, None]).sum(-1) - d[:, None]
    inside = dist <= eps[:, None]
    v_next = verts.gather(1, nxt[..., None].expand(-1, -1, 3))
    d_next = dist.gather(1, nxt)
    in_next = inside.gather(1, nxt)
    denom = dist - d_next
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    v_int = verts + (dist / denom)[..., None] * (v_next - verts)
    valid = idx[None] < count[:, None]
    emit_int = (inside != in_next) & valid
    emit_next = in_next & valid
    # per edge, the intersection then the next vertex
    cand = torch.stack([v_int, v_next], 2).reshape(-1, 2 * m, 3)
    flags = torch.stack([emit_int, emit_next], 2).reshape(-1, 2 * m)
    order = torch.argsort((~flags).to(torch.uint8), dim=1, stable=True)[:, :m]
    return cand.gather(1, order[..., None].expand(-1, -1, 3)), flags.sum(1)


def _intersect_volume(c1: torch.Tensor, c2: torch.Tensor, eps_rel: float = 1e-6) -> torch.Tensor:
    """Intersection volumes (P,) of box pairs given as corners (P, 8, 3) each."""
    p = c1.shape[0]
    shift = (c1.mean(1) + c2.mean(1)) * 0.5  # centre the pair
    a, b = c1 - shift[:, None], c2 - shift[:, None]
    scale = torch.maximum(a.abs().amax((1, 2)), b.abs().amax((1, 2)))
    eps = eps_rel * scale.clamp_min(1e-6)
    na, da = _face_planes(a)
    nb, db = _face_planes(b)
    # 12 clip jobs a pair: A's faces against B's planes keeping coincident
    # patches (+eps), B's against A's discarding them (-eps), so a shared
    # surface counts once
    quads = torch.cat([_faces(a), _faces(b)], 1).reshape(p * 12, 4, 3)
    planes_n = torch.cat([nb[:, None].expand(-1, 6, -1, -1), na[:, None].expand(-1, 6, -1, -1)], 1)
    planes_n = planes_n.reshape(p * 12, 6, 3)
    planes_d = torch.cat([db[:, None].expand(-1, 6, -1), da[:, None].expand(-1, 6, -1)], 1).reshape(p * 12, 6)
    eps_j = torch.cat([eps[:, None].expand(-1, 6), -eps[:, None].expand(-1, 6)], 1).reshape(-1)
    sign = torch.cat([_winding_sign(a)[:, None].expand(-1, 6), _winding_sign(b)[:, None].expand(-1, 6)], 1)

    verts = torch.zeros(p * 12, MAX_VERTS, 3, dtype=c1.dtype, device=c1.device)
    verts[:, :4] = quads
    count = torch.full((p * 12,), 4, dtype=torch.int64, device=c1.device)
    for i in range(6):
        verts, count = _clip(verts, count, planes_n[:, i], planes_d[:, i], eps_j)
    # signed fan volume about the origin: (1/6) sum_i p0 . (p_i x p_{i+1})
    i = torch.arange(MAX_VERTS, device=c1.device)
    tri_ok = (i[None] >= 1) & (i[None] <= count[:, None] - 2)
    pj = verts[:, torch.clamp(i + 1, max=MAX_VERTS - 1)]
    tri = (verts[:, :1] * torch.cross(verts, pj, dim=-1)).sum(-1) / 6.0
    vol = torch.where(tri_ok, tri, torch.zeros_like(tri)).sum(1).reshape(p, 12)
    return (vol * sign).sum(1).clamp_min(0.0)


def iou3d_pairs(corners1: torch.Tensor, corners2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Matched pairs: corners (P, 8, 3) each -> (intersection volume (P,), IoU (P,)).

    A pair with a non-finite or a zero-volume box scores 0."""
    c1, c2 = corners1.to(torch.float32), corners2.to(torch.float32)
    bad = ~(torch.isfinite(c1).all(2).all(1) & torch.isfinite(c2).all(2).all(1))
    c1 = torch.where(bad[:, None, None], torch.zeros_like(c1), c1)
    c2 = torch.where(bad[:, None, None], torch.zeros_like(c2), c2)
    inter = torch.cat([_intersect_volume(c1[s:s + CHUNK], c2[s:s + CHUNK]) for s in range(0, len(c1), CHUNK)]
                      ) if len(c1) else c1.new_zeros(0)
    v1, v2 = box_volume(c1), box_volume(c2)
    inter = torch.minimum(inter, torch.minimum(v1, v2))
    union = v1 + v2 - inter
    zero = bad | (v1 < 1e-9) | (v2 < 1e-9) | (union <= 0)
    iou = torch.where(zero, torch.zeros_like(inter), inter / union.clamp_min(1e-12))
    return torch.where(bad, torch.zeros_like(inter), inter), iou


def box3d_overlap(corners1: torch.Tensor, corners2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every pair: corners1 (N, 8, 3), corners2 (M, 8, 3) -> (intersection
    volume (N, M), IoU (N, M))."""
    n, m = corners1.shape[0], corners2.shape[0]
    vol, iou = iou3d_pairs(corners1.repeat_interleave(m, 0), corners2.repeat(n, 1, 1))
    return vol.reshape(n, m), iou.reshape(n, m)
