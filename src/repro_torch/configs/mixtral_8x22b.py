"""Mixtral 8x22B — MoE, GQA, sliding-window attention [arXiv:2401.04088; hf]."""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=32768, n_experts=8, top_k=2, sliding_window=4096,
    rope_theta=1e6,
)
