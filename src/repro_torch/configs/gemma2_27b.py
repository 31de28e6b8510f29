"""Gemma 2 27B — alternating local(SWA-4096)/global attention, logit
softcaps, head_dim 128 [arXiv:2408.00118; hf]."""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_ff=36864,
    vocab=256000, sliding_window=4096, local_global_period=2,
    attn_softcap=50.0, logit_softcap=30.0, head_dim=128,
    activation="gelu",
)
