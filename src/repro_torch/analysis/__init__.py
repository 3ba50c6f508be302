"""The analysis tier: analysis mode, the cost count on the meta device and
the H100 roofline (port of ``repro.analysis``)."""
from repro_torch.analysis.mode import analysis_mode, in_analysis_mode
from repro_torch.analysis.roofline import (H100_SXM, Roofline, analyze,
                                           model_flops)

__all__ = ["H100_SXM", "Roofline", "analysis_mode", "analyze",
           "in_analysis_mode", "model_flops"]
