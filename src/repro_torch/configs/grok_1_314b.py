"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1; unverified]."""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    n_experts=8,
    topk=2,
    moe_d_ff=32768,
    attn_softcap=30.0,  # grok uses attention logit capping
    logit_softcap=30.0,
    tie_embeddings=False,
    notes="every layer MoE (8e top-2)",
)
