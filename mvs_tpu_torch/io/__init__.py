from mvs_tpu_torch.io.cams import CameraParams, read_cam_file, write_cam_file
from mvs_tpu_torch.io.pairs import read_pair_file, write_pair_file
from mvs_tpu_torch.io.pfm import read_pfm, write_pfm
from mvs_tpu_torch.io.ply import read_ply, write_ply
from mvs_tpu_torch.io.png import read_png, write_png

__all__ = ["read_pfm", "write_pfm", "CameraParams", "read_cam_file",
           "write_cam_file", "read_pair_file", "write_pair_file", "read_ply",
           "write_ply", "read_png", "write_png"]
