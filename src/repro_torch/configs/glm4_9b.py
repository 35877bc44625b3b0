"""GLM4-9B: RoPE, extreme GQA (kv=2) [hf:THUDM/glm-4-9b; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense", num_layers=40, d_model=4096,
    num_heads=32, num_kv_heads=2, d_ff=13696, vocab_size=151552,
    rope_theta=10_000.0, attn_query_chunk=1024,
    notes="kv_heads=2 < TP width: decode shards the KV sequence axis")
