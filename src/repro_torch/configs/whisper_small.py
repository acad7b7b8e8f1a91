"""whisper-small [audio] — enc-dec, conv frontend (stub)
[arXiv:2212.04356; unverified].

12 encoder + 12 decoder layers; ``input_specs()`` provides precomputed
frame embeddings (B, S, d) in place of the mel+conv frontend."""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    rope="none",  # sinusoidal positions (whisper-style)
    encdec=True,
    enc_layers=12,
    dec_ratio=8,
    tie_embeddings=True,
    notes="enc-dec; decode = 1 decoder token vs S-frame cross KV",
)
