"""starcoder2-7b [dense] — GQA, RoPE [arXiv:2402.19173; hf]."""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    notes="full attention",
)
