"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

d_ff=0 per the assignment: xLSTM blocks carry their own up/down
projections (mLSTM pf=2, sLSTM pf=4/3).  Pattern: one sLSTM per three
mLSTM blocks (the paper's x:1 ratios)."""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    pattern=("mlstm", "mlstm", "mlstm", "slstm") * 3,
    chunk=256,
    tie_embeddings=True,
    notes="runs long_500k (linear-time recurrence)",
)
