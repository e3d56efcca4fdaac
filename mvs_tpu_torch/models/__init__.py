from mvs_tpu_torch.models.cas_mvsnet import CasMVSNet

__all__ = ["CasMVSNet"]
