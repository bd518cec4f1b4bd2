from slam2d_tpu_torch.viz.render import render_map, save_map_png  # noqa: F401
