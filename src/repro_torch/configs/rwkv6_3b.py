"""RWKV6 (Finch) 3B: attention-free, data-dependent decay
[arXiv:2404.05892; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm", num_layers=32, d_model=2560,
    num_heads=0, num_kv_heads=0, d_ff=8960, vocab_size=65536,
    rwkv_head_dim=64, ssm_chunk=64,
    notes="constant-size state -> long_500k runs; chunked 3-pass WKV")
