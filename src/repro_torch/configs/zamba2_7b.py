"""zamba2-7b [hybrid] — Mamba2 + shared attn blocks
[arXiv:2411.15242; unverified].

81 layers: 75 Mamba2 blocks with the SAME shared transformer block
(weights shared, caches distinct) applied at 6 evenly spaced points —
the Zamba2 shared-block design at the assignment's sizes."""


def _pattern():
    out = []
    shared_at = {6, 19, 32, 45, 58, 71}
    for i in range(81):
        out.append("shared_attn" if i in shared_at else "mamba")
    return tuple(out)


from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    pattern=_pattern(),
    ssm_state=64,
    ssm_expand=2,
    conv_kernel=4,
    chunk=256,
    tie_embeddings=True,
    notes="runs long_500k (mamba recurrence; shared-attn KV is O(S) decode)",
)
