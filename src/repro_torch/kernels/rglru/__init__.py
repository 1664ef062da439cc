from repro_torch.kernels.rglru.kernel import rglru_scan_b
from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.kernels.rglru.ref import rglru_ref

__all__ = ["rglru_scan", "rglru_scan_b", "rglru_ref"]
