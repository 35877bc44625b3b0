"""Config system: model architecture + input-shape cases + registry.

A framework-free copy of the reference's ``repro.configs`` (the port
imports nothing of the JAX package); ``tests/test_torch_configs.py`` holds
every field of every config against it."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                  # 0 for attention-free
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    qkv_bias: bool = False
    activation: str = "silu_glu"    # silu_glu | sq_relu | gelu
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None
    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "capacity"  # capacity | sorted
    # SSM / hybrid
    ssm_state: int = 0
    rwkv_head_dim: int = 64
    ssm_chunk: int = 64
    # modality frontend (stubbed: precomputed embeddings)
    frontend: Optional[str] = None  # vision_stub | audio_stub
    frontend_len: int = 0           # prefix positions fed as embeddings
    # training-time structure
    scan_layers: bool = True
    remat: bool = True
    attn_query_chunk: Optional[int] = None  # flash-style score blocking
    swa_banded: bool = False        # banded SWA: only compute window band
    seq_sharded_activations: bool = False   # Megatron-SP saved activations
    loss_seq_chunk: Optional[int] = None    # chunked cross-entropy
    # roofline-unit builds only: python-unroll inner chunk loops so
    # cost_analysis counts every iteration (lax.scan bodies count once)
    unroll_inner_scans: bool = False
    moe_ep_pins: bool = False       # pin MoE expert buffers to the EP axis
    grad_accum_bf16: bool = False   # bf16 grad accumulation (halves the
    # accumulator + per-microbatch reduce-wire; Adam runs on the f32 cast)
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Embedding/head tables padded to 256 (= 16 data x 16 model) so the
        vocab axis shards evenly on the production mesh (internvl2's 151655
        and hymba's 32001 are not 16-divisible).  Loss masks the pad."""
        return -(-self.vocab_size // 256) * 256

    @property
    def rwkv_num_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-scale config of the same family (for CPU tests)."""
        kv_ratio = max(self.num_heads // max(self.num_kv_heads, 1), 1)
        num_heads = 4
        num_kv_heads = max(num_heads // min(kv_ratio, 4), 1)
        base = dict(
            name=self.name + "-reduced", family=self.family, num_layers=2,
            d_model=64, num_heads=0 if self.num_heads == 0 else num_heads,
            num_kv_heads=0 if self.num_heads == 0 else num_kv_heads,
            d_ff=96, vocab_size=256, head_dim=16, qkv_bias=self.qkv_bias,
            activation=self.activation, rope_theta=self.rope_theta,
            sliding_window=None if self.sliding_window is None else 8,
            num_experts=min(self.num_experts, 8) if self.num_experts else 0,
            num_shared_experts=min(self.num_shared_experts, 2),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            capacity_factor=self.capacity_factor,
            moe_dispatch=self.moe_dispatch,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            rwkv_head_dim=16, ssm_chunk=8, frontend=self.frontend,
            frontend_len=4 if self.frontend else 0,
            scan_layers=self.scan_layers, remat=False, notes="reduced",
        )
        base.update(overrides)
        return ModelConfig(**base)


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode
    # decode shapes lower serve_step: one new token, KV cache of seq_len.


SHAPES: Dict[str, ShapeCase] = {
    "train_4k": ShapeCase("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524_288, 1, "decode"),
}

# Archs whose long_500k cell runs (sub-quadratic / bounded-state decode).
SUBQUADRATIC = {"rwkv6-3b", "hymba-1.5b", "h2o-danube-3-4b"}

ARCH_IDS: List[str] = [
    "olmoe_1b_7b", "deepseek_moe_16b", "h2o_danube3_4b", "qwen15_05b",
    "nemotron4_340b", "glm4_9b", "rwkv6_3b", "internvl2_1b",
    "musicgen_large", "hymba_15b",
]


def get_config(arch: str) -> ModelConfig:
    """Load ``src/repro_torch/configs/<arch>.py`` (dashes normalized)."""
    mod_name = arch.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> List[ModelConfig]:
    return [get_config(a) for a in ARCH_IDS]


def cells_for(cfg: ModelConfig) -> List[Tuple[str, ShapeCase]]:
    """The (shape) cells assigned to an arch, honoring the long_500k and
    encoder-only skip rules (all assigned archs are decoder LMs)."""
    out = []
    for name, case in SHAPES.items():
        if name == "long_500k" and cfg.name not in SUBQUADRATIC:
            continue  # pure full-attention: no sub-quadratic 500k path
        out.append((name, case))
    return out
