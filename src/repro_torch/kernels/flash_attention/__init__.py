from repro_torch.kernels.flash_attention.kernel import (attention_plain,
                                                        flash_attention)
from repro_torch.kernels.flash_attention.ops import gqa_flash

__all__ = ["attention_plain", "flash_attention", "gqa_flash"]
