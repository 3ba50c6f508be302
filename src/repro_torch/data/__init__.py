from repro_torch.data.fcpr import FCPRSampler
from repro_torch.data.synthetic import make_lm_tokens

__all__ = ["FCPRSampler", "make_lm_tokens"]
