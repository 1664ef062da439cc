from repro_torch.kernels.ssd.kernel import ssd_bh
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_ref_bh

__all__ = ["ssd", "ssd_bh", "ssd_chunked_ref", "ssd_ref_bh"]
