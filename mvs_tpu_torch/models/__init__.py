from mvs_tpu_torch.models.cas_mvsnet import CasMVSNet
from mvs_tpu_torch.models.cvp_mvsnet import CVPMVSNet
from mvs_tpu_torch.models.mvsnet import MVSNet

__all__ = ["CasMVSNet", "CVPMVSNet", "MVSNet"]
