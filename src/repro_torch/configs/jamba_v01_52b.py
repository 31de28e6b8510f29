"""Jamba v0.1 52B — hybrid Mamba+attention (1:7), MoE every other layer
[arXiv:2403.19887; hf]."""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=65536, n_experts=16, top_k=2, moe_every=2, moe_offset=1,
    ssm_kind="mamba", attn_period=8, attn_offset=3,
)
