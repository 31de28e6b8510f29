"""PaliGemma 3B — SigLIP patch frontend (STUB: input_specs() feeds 256
precomputed patch embeddings) + gemma decoder as a prefix-LM
[arXiv:2407.07726; hf]."""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab=257216, is_prefix_lm=True, prefix_len=256,
    frontend="patch_stub", activation="gelu", head_dim=256,
)
