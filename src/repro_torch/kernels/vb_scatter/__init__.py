from repro_torch.kernels.vb_scatter.kernel import permute_rows, take_rows
from repro_torch.kernels.vb_scatter.ops import scatter_rows, vb_scatter
from repro_torch.kernels.vb_scatter.ref import (permute_rows_ref,
                                                scatter_rows_ref,
                                                vb_scatter_ref)

__all__ = ["permute_rows", "take_rows", "scatter_rows", "vb_scatter",
           "permute_rows_ref", "scatter_rows_ref", "vb_scatter_ref"]
