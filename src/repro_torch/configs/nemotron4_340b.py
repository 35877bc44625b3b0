"""Nemotron-4-340B: GQA + squared-ReLU MLP [arXiv:2402.16819; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense", num_layers=96, d_model=18432,
    num_heads=96, num_kv_heads=8, d_ff=73728, vocab_size=256000,
    head_dim=192, activation="sq_relu", rope_theta=10_000.0,
    loss_seq_chunk=512, grad_accum_bf16=True, attn_query_chunk=1024,
    notes="memory-limiting arch; perf cell C: chunked CE + bf16 grad accum "
          "by default, seq_sharded_activations as the HBM-bound lever")
