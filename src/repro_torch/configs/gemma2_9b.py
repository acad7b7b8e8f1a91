"""gemma2-9b [dense] — local+global alternating, logit softcap
[arXiv:2408.00118; hf]."""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14336,
    vocab=256000,
    head_dim=256,
    pattern=("local", "attn") * 21,
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
    notes="head_dim=256 explicit; alternating 4k-window local / global",
)
