from mvs_tpu_torch.models.cas_mvsnet import CasMVSNet
from mvs_tpu_torch.models.cvp_mvsnet import CVPMVSNet

__all__ = ["CasMVSNet", "CVPMVSNet"]
