"""Host-side software mesh rasterizer for scene visualisation (counterpart of
``threedod/vis/render.py``, line for line, so its output is bit-equal).

The reference renders cuboid meshes with PyTorch3D
(cubercnn/util/math_util.py:935-1010 get_camera/get_basic_renderer — a
perspective camera in screen space, SoftPhongShader with a point light at
the origin, faces_per_pixel=1, perspective_correct=False) and composites
them in cubercnn/vis/vis.py:210-546.  The TPU-native framework keeps
visualisation off the accelerator: this module is a small z-buffered
numpy rasterizer with the same camera model (pixel-space K), the same
near-plane behaviour, and a Phong-like point-light-at-origin shading so
the rendered panels look and composite like the reference's. It stays on
the host in float64.

Conventions: camera at the origin looking down +Z, K in pixel units,
verts in camera space, faces wound outward.  Returns float RGB in [0, 1]
plus an alpha (silhouette) mask — exactly what draw_scene_view needs for
its blend-by-silhouette compositing (vis.py:283-287).
"""
from __future__ import annotations

import numpy as np

ZNEAR = 0.05

# triangle faces of a cuboid's 8 corners (the JAX package's TRI_FACES, the
# reference's math_util.py:221-239), wound outward
TRI_FACES = np.array(
    [
        [0, 1, 2], [2, 3, 0],      # front
        [1, 5, 6], [6, 2, 1],      # right
        [4, 0, 3], [3, 7, 4],      # left
        [5, 4, 7], [7, 6, 5],      # back
        [4, 5, 1], [1, 0, 4],      # top
        [3, 2, 6], [6, 7, 3],      # bottom
    ],
    dtype=np.int32,
)

# PyTorch3D PointLights defaults (ambient .5, diffuse .3, specular .2),
# shininess 64 — the reference's shading setup (math_util.py:976-977).
_AMBIENT = 0.5
_DIFFUSE = 0.3
_SPECULAR = 0.2
_SHININESS = 64.0


def _clip_near(tri: np.ndarray, znear: float) -> list[np.ndarray]:
    """Sutherland–Hodgman clip of one triangle (3, 3) against z >= znear;
    returns 0-2 triangles (fan of the clipped polygon)."""
    poly = list(tri)
    out: list[np.ndarray] = []
    n = len(poly)
    for i in range(n):
        a, b = poly[i], poly[(i + 1) % n]
        ain, bin_ = a[2] >= znear, b[2] >= znear
        if ain:
            out.append(a)
        if ain != bin_:
            t = (znear - a[2]) / (b[2] - a[2])
            out.append(a + t * (b - a))
    if len(out) < 3:
        return []
    return [np.stack([out[0], out[i], out[i + 1]]) for i in range(1, len(out) - 1)]


def _shade(color: np.ndarray, centroid: np.ndarray, normal: np.ndarray) -> np.ndarray:
    """Flat Phong shading with the point light at the camera origin."""
    n = normal / (np.linalg.norm(normal) + 1e-12)
    # orient the normal toward the camera (origin): the vector from the
    # surface to the camera is -centroid
    view = -centroid / (np.linalg.norm(centroid) + 1e-12)
    if np.dot(n, view) < 0:
        n = -n
    l = view  # light sits at the camera
    ndotl = max(0.0, float(np.dot(n, l)))
    refl = 2.0 * ndotl * n - l
    spec = max(0.0, float(np.dot(refl, view))) ** _SHININESS
    return np.clip(color * (_AMBIENT + _DIFFUSE * ndotl) + _SPECULAR * spec, 0.0, 1.0)


def rasterize(
    verts: np.ndarray,
    faces: np.ndarray,
    face_colors: np.ndarray,
    K: np.ndarray,
    width: int,
    height: int,
    znear: float = ZNEAR,
):
    """Z-buffered flat-shaded rasterization.

    Args:
        verts: (V, 3) camera-space vertices.
        faces: (F, 3) int vertex indices.
        face_colors: (F, 3) base albedo in [0, 1].
        K: (3, 3) pixel-space intrinsics.
    Returns:
        rgb (H, W, 3) float in [0, 1], alpha (H, W) bool, zbuf (H, W) float.
    """
    verts = np.asarray(verts, np.float64)
    K = np.asarray(K, np.float64)
    rgb = np.zeros((height, width, 3), np.float64)
    alpha = np.zeros((height, width), bool)
    zbuf = np.full((height, width), np.inf)

    for f_idx, f in enumerate(np.asarray(faces, np.int64)):
        tri0 = verts[f]
        base = np.asarray(face_colors[f_idx], np.float64)
        for tri in _clip_near(tri0, znear):
            z = tri[:, 2]
            u = K[0, 0] * tri[:, 0] / z + K[0, 2]
            v = K[1, 1] * tri[:, 1] / z + K[1, 2]
            x0, x1 = int(np.floor(u.min())), int(np.ceil(u.max()))
            y0, y1 = int(np.floor(v.min())), int(np.ceil(v.max()))
            x0, x1 = max(x0, 0), min(x1 + 1, width)
            y0, y1 = max(y0, 0), min(y1 + 1, height)
            if x0 >= x1 or y0 >= y1:
                continue
            gx, gy = np.meshgrid(
                np.arange(x0, x1) + 0.5, np.arange(y0, y1) + 0.5
            )
            # screen-space barycentric (perspective_correct=False, matching
            # the reference's RasterizationSettings, math_util.py:967-972)
            d = (v[1] - v[2]) * (u[0] - u[2]) + (u[2] - u[1]) * (v[0] - v[2])
            if abs(d) < 1e-12:
                continue
            w0 = ((v[1] - v[2]) * (gx - u[2]) + (u[2] - u[1]) * (gy - v[2])) / d
            w1 = ((v[2] - v[0]) * (gx - u[2]) + (u[0] - u[2]) * (gy - v[2])) / d
            w2 = 1.0 - w0 - w1
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
            if not inside.any():
                continue
            zi = w0 * z[0] + w1 * z[1] + w2 * z[2]
            sub_z = zbuf[y0:y1, x0:x1]
            upd = inside & (zi < sub_z) & (zi > 0)
            if not upd.any():
                continue
            normal = np.cross(tri0[1] - tri0[0], tri0[2] - tri0[0])
            shaded = _shade(base, tri0.mean(0), normal)
            sub_z[upd] = zi[upd]
            rgb[y0:y1, x0:x1][upd] = shaded
            alpha[y0:y1, x0:x1] |= upd
    return rgb, alpha, zbuf


def cuboid_mesh_scene(corners3d: np.ndarray, colors):
    """Join (N, 8, 3) cuboid corner sets into one (verts, faces, face_colors)
    scene (reference: mesh_cuboid + join_meshes_as_scene,
    math_util.py:912-933 / vis.py:263)."""
    corners3d = np.asarray(corners3d, np.float64)
    n = len(corners3d)
    verts = corners3d.reshape(n * 8, 3)
    faces = np.concatenate([TRI_FACES + 8 * i for i in range(n)], 0)
    fc = np.repeat(np.asarray(colors, np.float64).reshape(n, 1, 3), len(TRI_FACES), 1)
    return verts, faces, fc.reshape(-1, 3)


def render_cuboids(
    corners3d: np.ndarray,
    colors,
    K: np.ndarray,
    width: int,
    height: int,
    znear: float = ZNEAR,
):
    """Render N cuboids as one z-buffered scene. colors in [0, 1] per box."""
    if len(corners3d) == 0:
        return (
            np.zeros((height, width, 3)),
            np.zeros((height, width), bool),
            np.full((height, width), np.inf),
        )
    verts, faces, fc = cuboid_mesh_scene(corners3d, colors)
    return rasterize(verts, faces, fc, K, width, height, znear)
