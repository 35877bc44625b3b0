"""OLMoE-1B-7B: 64-expert top-8 MoE [arXiv:2409.02060; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe", num_layers=16, d_model=2048,
    num_heads=16, num_kv_heads=16, d_ff=1024, vocab_size=50304,
    rope_theta=10_000.0, num_experts=64, top_k=8, moe_dispatch="grouped",
    attn_query_chunk=1024,
    notes="fully MoE FFN; d_ff is the per-expert width")
