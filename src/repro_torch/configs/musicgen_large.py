"""MusicGen-large: decoder-only over EnCodec tokens [arXiv:2306.05284; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio", num_layers=48, d_model=2048,
    num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=2048,
    activation="gelu", attn_query_chunk=1024,
    frontend="audio_stub", frontend_len=64,
    notes="EnCodec frontend stubbed: conditioning frames as embeddings")
