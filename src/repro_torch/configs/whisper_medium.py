"""Whisper medium — encoder-decoder; conv audio frontend is a STUB:
input_specs() feeds precomputed 1500-frame embeddings [arXiv:2212.04356]."""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=51865, is_encdec=True, encoder_layers=24, encoder_seq=1500,
    frontend="audio_stub", activation="gelu",
)
