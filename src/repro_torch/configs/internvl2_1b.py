"""InternVL2-1B: InternViT (stub) + Qwen2-0.5B-flavoured LM backbone
[arXiv:2404.16821; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm", num_layers=24, d_model=896,
    num_heads=14, num_kv_heads=2, d_ff=4864, vocab_size=151655,
    qkv_bias=True, rope_theta=1_000_000.0, attn_query_chunk=1024,
    frontend="vision_stub",
    frontend_len=256,
    notes="frontend stub: input_specs() provides 256 patch embeddings")
