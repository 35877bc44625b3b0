"""DeepSeekMoE-16B: fine-grained 64 routed top-6 + 2 shared [arXiv:2401.06066; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe", num_layers=28, d_model=2048,
    num_heads=16, num_kv_heads=16, d_ff=1408, vocab_size=102400,
    rope_theta=10_000.0, num_experts=64, num_shared_experts=2, top_k=6,
    moe_dispatch="grouped", attn_query_chunk=1024,
    notes="fine-grained experts; shared experts bypass the router")
