from mvs_tpu_torch.geometry.depth import cascade_depth_samples
from mvs_tpu_torch.geometry.homography import (pixel_grid, plane_sweep_coords,
                                               warp_src_feature)
from mvs_tpu_torch.geometry.projection import (compose_projection,
                                               relative_projection,
                                               scale_intrinsics)
from mvs_tpu_torch.geometry.sampling import bilinear_sample

__all__ = [
    "compose_projection", "scale_intrinsics", "relative_projection",
    "bilinear_sample", "pixel_grid", "plane_sweep_coords",
    "warp_src_feature", "cascade_depth_samples",
]
