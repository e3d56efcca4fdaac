from mvs_tpu_torch.geometry.consistency import (ReprojectionResult,
                                                geometric_consistency,
                                                reproject_with_depth)
from mvs_tpu_torch.geometry.depth import cascade_depth_samples
from mvs_tpu_torch.geometry.homography import (pixel_grid, plane_sweep_coords,
                                               warp_src_feature)
from mvs_tpu_torch.geometry.projection import (compose_projection,
                                               invert_rigid,
                                               relative_projection,
                                               scale_intrinsics)
from mvs_tpu_torch.geometry.sampling import bilinear_sample

__all__ = [
    "compose_projection", "scale_intrinsics", "relative_projection",
    "invert_rigid", "bilinear_sample", "pixel_grid", "plane_sweep_coords",
    "warp_src_feature", "cascade_depth_samples", "ReprojectionResult",
    "reproject_with_depth", "geometric_consistency",
]
