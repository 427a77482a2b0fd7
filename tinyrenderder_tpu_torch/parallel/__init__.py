"""Multi-rank rendering: the frame, or each pass's faces, split over the
ranks of a ``torch.distributed`` process group (``dist``)."""

from tinyrenderder_tpu_torch.parallel.dist import (emulated_mesh, make_mesh, make_mesh_grid,
                                                    render_frame_fused_image_sharded,
                                                    render_frame_fused_sharded,
                                                    render_frame_geometry_tiles)

__all__ = ["make_mesh", "make_mesh_grid", "emulated_mesh", "render_frame_fused_sharded",
           "render_frame_fused_image_sharded", "render_frame_geometry_tiles"]
