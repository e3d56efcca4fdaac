from mvs_tpu_torch.fusion.fuse import (FusionConfig, compact_points,
                                       fuse_depth_maps, fuse_scene, fuse_view,
                                       pad_pairs)

__all__ = ["FusionConfig", "fuse_depth_maps", "fuse_scene", "fuse_view",
           "pad_pairs", "compact_points"]
