"""H2O-Danube3-4B: llama+mistral mix with sliding-window attention
[arXiv:2401.16818; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense", num_layers=24, d_model=3840,
    num_heads=32, num_kv_heads=8, d_ff=10240, vocab_size=32000,
    head_dim=120, rope_theta=10_000.0, sliding_window=4096,
    attn_query_chunk=1024, swa_banded=True,
    notes="SWA window 4096 bounds the decode cache -> long_500k runs")
