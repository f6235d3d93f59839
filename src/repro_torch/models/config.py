"""Model configuration for all assigned architectures.

A model is a stack of GROUPS scanned `n_groups` times; each group is a
fixed tuple of layer specs (attention / ssm variants + mlp / moe). This
keeps the lowered HLO small (one group body) while expressing the
heterogeneous patterns (gemma2 local/global alternation, jamba 1:7
mamba:attention interleave with MoE every other layer).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str  # "attn" | "ssm"
    mlp: str  # "dense" | "moe" | "none"
    sliding_window: Optional[int] = None  # local attention window (gemma2)
    cross_attn: bool = False  # enc-dec decoder layers


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int  # per-expert hidden size
    capacity_factor: float = 1.25  # per-expert buffer = T*k/E * this


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64  # SSD head dim (d_inner / n_heads)
    chunk: int = 256  # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 → d_model // n_heads
    group: Sequence[LayerSpec] = ()  # layer pattern; scanned n_layers/len(group) times
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    rope_theta: float = 10000.0
    mrope_sections: Optional[tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    tie_embeddings: bool = False
    # enc-dec
    n_enc_layers: int = 0  # >0 → encoder-decoder
    # modality frontend stub: model consumes precomputed embeddings
    frontend: Optional[str] = None  # None | "audio" | "vision"
    act: str = "silu"  # mlp activation
    norm_eps: float = 1e-6
    # which shapes are runnable (DESIGN.md §4): full-attention archs skip long_500k
    sub_quadratic: bool = False
    decoder: bool = True  # False → encoder-only (no decode shapes)

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_groups(self) -> int:
        assert self.n_layers % len(self.group) == 0, (self.name, self.n_layers, len(self.group))
        return self.n_layers // len(self.group)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    def num_params(self) -> int:
        """Total parameter count (embedding + layers), for roofline math."""
        d, h = self.d_model, self.head_dim_
        total = self.vocab * d * (1 if self.tie_embeddings else 2)

        def layer_params(spec: LayerSpec) -> int:
            n = 2 * d  # 2 rmsnorm scales
            if spec.kind == "attn":
                qkv = d * h * (self.n_heads + 2 * self.n_kv_heads)
                n += qkv + self.n_heads * h * d
                if spec.cross_attn:
                    n += qkv + self.n_heads * h * d + d
            else:  # ssm
                s = self.ssm
                d_in = s.expand * d
                # in_proj (x, z, B, C, dt) + conv + out_proj (approximate mamba2)
                nh = d_in // s.head_dim
                n += d * (2 * d_in + 2 * s.d_state + nh) + d_in * s.d_conv + d_in * d + 2 * nh
            if spec.mlp == "dense":
                n += 3 * d * self.d_ff
            elif spec.mlp == "moe":
                n += self.moe.num_experts * 3 * d * self.moe.d_ff + d * self.moe.num_experts
            return n

        per_group = sum(layer_params(s) for s in self.group)
        total += per_group * self.n_groups
        if self.is_encdec:
            enc_spec = LayerSpec(kind="attn", mlp="dense")
            total += self.n_enc_layers * layer_params(enc_spec)
        return total

    def num_active_params(self) -> int:
        """Active parameters per token (MoE: top_k of num_experts)."""
        if self.moe is None:
            return self.num_params()
        full = self.num_params()
        moe_layers = sum(1 for s in self.group if s.mlp == "moe") * self.n_groups
        all_experts = moe_layers * self.moe.num_experts * 3 * self.d_model * self.moe.d_ff
        active = moe_layers * self.moe.top_k * 3 * self.d_model * self.moe.d_ff
        return full - all_experts + active


def dense_group(n: int = 1, **kw) -> tuple[LayerSpec, ...]:
    return tuple(LayerSpec(kind="attn", mlp="dense", **kw) for _ in range(n))
