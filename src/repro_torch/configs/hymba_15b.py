"""Hymba-1.5B: parallel attention + mamba heads per layer
[arXiv:2411.13676; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", num_layers=32, d_model=1600,
    num_heads=25, num_kv_heads=5, d_ff=5504, vocab_size=32001,
    head_dim=64, ssm_state=16, sliding_window=1024, ssm_chunk=64,
    attn_query_chunk=1024, swa_banded=True,
    notes="attn branch uses SWA; mamba branch bounded state -> 500k runs")
