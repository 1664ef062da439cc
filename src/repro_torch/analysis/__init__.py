from repro_torch.analysis.dispatch_costs import Costs, analyze_step
from repro_torch.analysis.roofline import (DEVICE, HBM_BW, LINK_BW,
                                           PEAK_FLOPS, TF32_FLOPS, Roofline,
                                           model_flops,
                                           predict_reassembly_hbm_bytes,
                                           predict_train_collective_bytes,
                                           summarize)

__all__ = ["Costs", "DEVICE", "HBM_BW", "LINK_BW", "PEAK_FLOPS", "Roofline",
           "TF32_FLOPS", "analyze_step", "model_flops",
           "predict_reassembly_hbm_bytes", "predict_train_collective_bytes",
           "summarize"]
