"""Architecture registry (``repro/configs``): one module per assigned
architecture (--arch id), pure Python, the port's own copy."""
from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES, \
    shape_applies

_MODULES = {
    "mixtral-8x22b": "mixtral_8x22b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "xlstm-350m": "xlstm_350m",
    "whisper-medium": "whisper_medium",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "granite-3-8b": "granite_3_8b",
    "gemma2-27b": "gemma2_27b",
    "nemotron-4-15b": "nemotron_4_15b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "paligemma-3b": "paligemma_3b",
}

ARCH_IDS = list(_MODULES)


def get_arch(name: str) -> ArchConfig:
    import importlib
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.ARCH


def reduced(arch: ArchConfig, **overrides) -> ArchConfig:
    """A smoke-test-sized config of the same family (same pattern unit)."""
    import dataclasses
    small = dict(
        n_layers=arch.unit_len * 2, d_model=128,
        n_heads=max(2, min(4, arch.n_heads)),
        n_kv_heads=max(1, min(2, arch.n_kv_heads)),
        d_ff=0 if arch.d_ff == 0 else 256,
        vocab=512,
        n_experts=min(4, arch.n_experts), top_k=min(2, arch.top_k),
        encoder_layers=2 if arch.is_encdec else 0,
        encoder_seq=16 if arch.is_encdec else 0,
        prefix_len=8 if arch.is_prefix_lm else 0,
        sliding_window=64 if arch.sliding_window else None,
        head_dim=None,
    )
    small.update(overrides)
    return dataclasses.replace(arch, **small)
