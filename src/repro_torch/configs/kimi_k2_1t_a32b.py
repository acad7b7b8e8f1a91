"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8
[arXiv:2501.kimi2; unverified].

Assignment-faithful deviations (DESIGN.md Sec. 9): attention is GQA kv=8
per the table (public K2 uses MLA); d_ff=2048 is the per-expert hidden.
First layer dense + 1 shared expert, per the K2 paper."""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    pattern=("attn",) + ("moe",) * 60,
    n_experts=384,
    topk=8,
    moe_d_ff=2048,
    n_shared_experts=1,
    tie_embeddings=False,
    notes="GQA per assignment table (public checkpoint is MLA)",
)
