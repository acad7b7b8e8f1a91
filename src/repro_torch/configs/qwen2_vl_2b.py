"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Backbone only per the assignment: the vision patch frontend is a stub —
``input_specs()`` feeds precomputed patch/text embedding token ids plus the
(temporal, height, width) M-RoPE position ids."""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    rope="mrope",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    notes="patch frontend stubbed; M-RoPE bands 2:3:3 over (t,h,w)",
)
