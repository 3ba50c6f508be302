from repro_torch.kernels.fused_xent.kernel import fused_xent, xent_plain
from repro_torch.kernels.fused_xent.ops import fused_xent_sum

__all__ = ["fused_xent", "fused_xent_sum", "xent_plain"]
