"""Whisper-medium — encoder-decoder audio backbone [arXiv:2212.04356].

24 decoder layers (as assigned) + 24 encoder layers; the mel-spectrogram +
conv frontend is a STUB: ``input_specs`` provides precomputed frame
embeddings of shape (batch, encoder_seq, d_model).  Whisper uses learned
absolute positions and MHA (kv heads = heads = 16).

A copy of ``repro.configs.whisper_medium``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51865,
    encoder_layers=24, encoder_seq=1500, frontend="audio",
    source="arXiv:2212.04356",
)
