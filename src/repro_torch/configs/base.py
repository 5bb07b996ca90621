"""ArchConfig schema + the input-shape set shared by all LM architectures."""

from __future__ import annotations

import dataclasses

__all__ = ["ArchConfig", "SHAPES", "ShapeSpec"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | audio | vlm | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # attention / norm / mlp options
    qkv_bias: bool = False
    mlp_act: str = "silu"  # silu | geglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparam_ln
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    positions: str = "rope"  # rope | sinusoidal | none
    # block structure
    block_pattern: tuple[str, ...] = ("attn",)  # attn | local | rec | ssm
    window: int = 0  # local attention window
    kind: str = "decoder"  # decoder | encoder
    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25  # train/prefill; decode is dropless
    # SSM (mamba2)
    d_inner: int = 0
    ssm_heads: int = 0
    ssm_state: int = 0
    # modality stub frontends
    frontend: str = "none"  # none | audio_stub | vision_stub
    frontend_dim: int = 0  # audio frame feature dim
    num_patches: int = 0  # vision prefix length
    # capability flags
    sub_quadratic: bool = False  # can run long_500k
    # training defaults (overridable per shape at launch)
    remat: str = "full"  # none | full | dots
    grad_accum: int = 1

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def supports(self, shape: ShapeSpec) -> tuple[bool, str]:
        """Whether a shape cell applies (per spec skips, DESIGN.md §4)."""
        if shape.kind == "decode" and self.kind == "encoder":
            return False, "encoder-only arch has no decode step"
        if shape.name == "long_500k" and not self.sub_quadratic:
            return False, "pure full-attention arch: 500k decode is not sub-quadratic"
        return True, ""

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.hd
        n = v * d  # embedding
        if not self.tie_embeddings and self.kind != "encoder":
            n += d * v
        if self.kind == "encoder":
            n += d * v
        per = {}
        per["attn"] = d * self.num_heads * hd * 2 + d * self.num_kv_heads * hd * 2
        per["local"] = per["attn"]
        gated = 2 if self.mlp_act in ("silu", "geglu") else 1
        mlp = d * ff * (gated + 1)
        dh = d // max(self.num_heads, 1)
        per["rec"] = 3 * d * d + self.num_heads * dh * dh * 2
        if self.d_inner:
            per["ssm"] = (
                d * (2 * self.d_inner + 2 * self.ssm_state + self.ssm_heads)
                + self.d_inner * d
            )
        pattern = self.block_pattern
        for i in range(self.num_layers):
            kind = pattern[i % len(pattern)]
            n += per[kind]
            if kind in ("attn", "local"):
                if self.is_moe:
                    n += self.num_experts * d * ff * (gated + 1) + d * self.num_experts
                else:
                    n += mlp
            elif kind == "rec":
                n += mlp
        return n

    def active_param_count(self) -> int:
        """MoE: parameters touched per token (for MODEL_FLOPS)."""
        if not self.is_moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        gated = 2 if self.mlp_act in ("silu", "geglu") else 1
        dense_total = self.param_count() - self.num_layers * self.num_experts * d * ff * (
            gated + 1
        )
        return dense_total + self.num_layers * self.top_k * d * ff * (gated + 1)

    def flops_param_count(self) -> int:
        """Params participating in matmuls (MODEL_FLOPS = 6*this*tokens).

        The input embedding is a gather, not a matmul: subtract it unless
        tied (tied tables run in the head matmul).  For encoders the unused
        token table is excluded too."""
        n = self.active_param_count()
        if not self.tie_embeddings or self.kind == "encoder":
            n -= self.vocab_size * self.d_model
        return n
