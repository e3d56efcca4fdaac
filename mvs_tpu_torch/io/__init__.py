from mvs_tpu_torch.io.cams import CameraParams, read_cam_file, write_cam_file
from mvs_tpu_torch.io.pfm import read_pfm, write_pfm

__all__ = ["read_pfm", "write_pfm", "CameraParams", "read_cam_file",
           "write_cam_file"]
