"""Unified model configuration covering all assigned architecture families.

A copy of the JAX package's ``models/config.py``: one dataclass describes
dense / MoE / MLA / SSM / hybrid / enc-dec / VLM / audio stacks; per-arch
files in ``repro_torch.configs`` instantiate it. Reduced variants (for CPU
smoke tests) come from :meth:`ModelConfig.reduced`. The port runs the dense
family only (``models/transformer.py::check_family``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense | moe | ssm | hybrid | vlm | audio | embedding
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0                 # 0 -> d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5

    # ---- MoE ----
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                 # per-expert hidden dim
    moe_num_shared: int = 0           # deepseek shared experts
    moe_layer_start: int = 0          # first MoE layer (deepseek: 3 dense first)
    moe_layer_period: int = 1         # jamba: MoE every 2nd layer
    moe_capacity_factor: float = 1.25

    # ---- MLA (deepseek) ----
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False                 # multi-token-prediction extra head

    # ---- SSM / hybrid ----
    layer_pattern: str = ""           # per-period layer types, e.g. "AMMMMMMM"
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128              # SSD chunk length

    # ---- enc-dec / modality ----
    encoder_layers: int = 0           # >0 -> encoder-decoder
    modality: str = "text"            # text | vision | audio
    frontend_len_cap: int = 8192      # stubbed frontends cap their seq length

    # ---- serving / long-context ----
    sliding_window: int = 0           # >0 -> windowed attention (sub-quadratic)

    # ---- distribution (filled in by launch/steps for the active mesh) ----
    tp_size: int = 1                  # size of the "model" axis

    # ---- numerics / memory policy ----
    param_dtype: str = "float32"      # smoke tests; dry-run overrides to bf16
    compute_dtype: str = "float32"
    optimizer: str = "adamw"          # adamw | adafactor | sgd
    remat: bool = True
    train_microbatches: int = 1       # grad-accumulation splits per step
    prefill_chunk: int = 0            # 0 -> whole-seq prefill

    # ------------------------------------------------------------------ utils
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner_ssm // self.ssm_head_dim

    def layer_types(self) -> list[str]:
        """Per-layer mixer type: 'A' attention or 'M' mamba."""
        if not self.layer_pattern:
            return ["M" if self.arch_type == "ssm" else "A"] * self.num_layers
        pat = self.layer_pattern
        return [pat[i % len(pat)] for i in range(self.num_layers)]

    def is_moe_layer(self, i: int) -> bool:
        if self.moe_num_experts == 0:
            return False
        return i >= self.moe_layer_start and \
            (i - self.moe_layer_start) % self.moe_layer_period == 0

    def reduced(self, *, layers: int = 2, d_model: int = 256,
                experts: int = 4) -> "ModelConfig":
        """Smoke-test variant: same family, tiny dims (spec: 2 layers,
        d_model<=512, <=4 experts)."""
        heads = max(2, min(self.num_heads, d_model // 64))
        kv = heads if self.num_kv_heads == self.num_heads else max(1, heads // 2)
        changes = dict(
            num_layers=layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=64,
            d_ff=2 * d_model,
            vocab_size=min(self.vocab_size, 1024),
            train_microbatches=1,
            prefill_chunk=0,
            frontend_len_cap=256,
        )
        if self.moe_num_experts:
            changes.update(
                moe_num_experts=min(self.moe_num_experts, experts),
                moe_top_k=min(self.moe_top_k, 2),
                moe_d_ff=d_model,
                moe_layer_start=min(self.moe_layer_start, 1),
            )
        if self.mla:
            changes.update(q_lora_rank=min(self.q_lora_rank, 128) or 0,
                           kv_lora_rank=128, qk_nope_head_dim=64,
                           qk_rope_head_dim=32, v_head_dim=64)
        if self.ssm_state:
            changes.update(ssm_state=min(self.ssm_state, 32), ssm_head_dim=32,
                           ssm_chunk=32)
        if self.encoder_layers:
            changes.update(encoder_layers=layers)
        if self.layer_pattern:
            # keep the hybrid mix visible even at 2 layers: one of each
            changes.update(layer_pattern="AM"[:layers] if layers <= 2 else
                           self.layer_pattern)
        if self.sliding_window:
            changes.update(sliding_window=min(self.sliding_window, 64))
        return dataclasses.replace(self, **changes)
