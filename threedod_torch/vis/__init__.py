"""Drawings of detections (counterpart of ``threedod/vis``): the host
rasterizer (``render``), Pillow's drawing primitives on numpy images
(``draw``), scene views, BEV and evaluation dumps (``vis``), the AP tables
(``logperf``) and a PNG writer (``png``). Nothing here imports Pillow."""
from .logperf import print_ap_analysis_table, print_ap_category_table, print_omni_summary
from .png import read_png, write_png
from .render import cuboid_mesh_scene, rasterize, render_cuboids
from .vis import (
    draw_3d_box_from_verts,
    draw_bev,
    draw_box_3d,
    draw_boxes_2d,
    draw_scene_view,
    draw_text,
    euler2mat,
    get_color,
    render_scene_views,
    side_by_side,
    so3_relative_angle,
    visualize_from_instances,
)
