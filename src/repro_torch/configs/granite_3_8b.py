"""IBM Granite 3.0 8B — dense GQA llama-style
[hf:ibm-granite/granite-3.0-2b-base family; hf]."""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12800,
    vocab=49155,
)
