"""Visualization (reference `cubercnn.vis` surface): drawings, scene
renders and AP result tables."""
from .vis import (draw_2d_box, draw_3d_box, draw_bev, draw_scene_view,  # noqa: F401
                  get_color, rasterize_cuboids, render_scene_view,
                  visualize_training_sample)
from .logperf import (format_table, print_ap_analysis_table,  # noqa: F401
                      print_ap_category_table, print_cross_dataset_table,
                      print_dataset_results, print_per_category_table)
