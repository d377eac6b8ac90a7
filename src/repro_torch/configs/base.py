"""Configuration system (twin of ``repro/configs/base.py``).

Every assigned architecture is a frozen ``ModelConfig``; input shapes are
``ShapeConfig``.  Pure data, ported whole for every family (dense, vlm,
moe, ssm, hybrid, audio: ``models/model.py`` runs each); no torch import,
so the control plane and the tests read configs without a device.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

# --------------------------------------------------------------------------- #
# Model configuration
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1          # MoE replaces the FFN on layers where (i % moe_every == moe_offset)
    moe_offset: int = 0
    first_dense: int = 0        # first N layers use a dense FFN (deepseek-v2)
    dense_residual: bool = False  # arctic: dense MLP in parallel with the MoE
    capacity_factor: float = 1.25
    router_dtype: str = "float32"

    @property
    def enabled(self) -> bool:
        return self.n_experts > 0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2)."""

    q_lora_rank: int = 0          # 0 = no q compression
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block configuration."""

    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256            # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | audio | vlm | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # FFN activation: "swiglu" (llama-family) or "gelu" (whisper)
    ffn_act: str = "swiglu"
    # sub-configs
    moe: MoEConfig = MoEConfig()
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (jamba): one attention layer per `attn_period` layers, at `attn_pos`;
    # remaining mixers are mamba.
    attn_period: int = 0
    attn_pos: int = 4
    # encoder-decoder (whisper): n_layers is the decoder depth.
    is_encdec: bool = False
    n_enc_layers: int = 0
    enc_frames: int = 1500       # precomputed conv-frontend frames (stub)
    # misc
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # citation tag from the assignment table
    source: str = ""

    # ----------------------------------------------------------------- #
    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 so the vocab dim shards
        evenly over a 16-way model axis (whisper's 51866 is the offender)."""
        return -(-self.vocab // 256) * 256

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Archs that can run 500k-token decode (SSM state / hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def is_hybrid(self) -> bool:
        return self.attn_period > 0

    def param_count(self) -> int:
        """Approximate total parameter count N (embeddings included)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        H, K, hd = self.n_heads, self.n_kv_heads, self.head_dim
        total = V * D * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            if self.mla is not None:
                m = self.mla
                qin = m.q_lora_rank or D
                p = 0
                if m.q_lora_rank:
                    p += D * m.q_lora_rank
                p += qin * H * m.qk_head_dim                      # q up
                p += D * (m.kv_lora_rank + m.qk_rope_head_dim)    # kv down
                p += m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                p += H * m.v_head_dim * D                         # out
                return p
            return D * H * hd + 2 * D * K * hd + H * hd * D

        def dense_ffn(dff: int) -> int:
            mult = 3 if self.ffn_act == "swiglu" else 2
            return mult * D * dff

        def moe_ffn() -> int:
            m = self.moe
            p = D * m.n_experts                                    # router
            p += m.n_experts * dense_ffn(m.d_ff_expert) // 1
            if m.n_shared_experts:
                p += dense_ffn(m.n_shared_experts * m.d_ff_expert)
            if m.dense_residual:
                p += dense_ffn(F)
            return p

        def mamba_params() -> int:
            s = self.ssm
            di = s.d_inner(D)
            nh = s.n_heads(D)
            conv_dim = di + 2 * s.n_groups * s.d_state
            p = D * (2 * di + 2 * s.n_groups * s.d_state + nh)    # in_proj
            p += conv_dim * s.conv_width + conv_dim               # conv
            p += nh * 2                                           # A_log, D
            p += di                                               # dt_bias via nh? folded
            p += di * D                                           # out_proj
            return p

        if self.family == "ssm":
            total += L * (mamba_params() + D)
            return total

        n_moe = 0
        if self.moe.enabled:
            n_moe = sum(
                1
                for i in range(L)
                if i >= self.moe.first_dense
                and i % self.moe.moe_every == self.moe.moe_offset
            )
        n_dense_ffn = L - n_moe

        if self.is_hybrid:
            n_attn = L // self.attn_period
            n_mamba = L - n_attn
            total += n_attn * attn_params() + n_mamba * mamba_params()
        else:
            dec_attn = attn_params() * (2 if self.is_encdec else 1)  # self+cross
            total += L * dec_attn
            if self.is_encdec:
                total += self.n_enc_layers * (attn_params() + dense_ffn(F) + 2 * D)

        total += n_moe * moe_ffn() + n_dense_ffn * dense_ffn(F)
        total += L * 2 * D + D                                    # norms
        return total

    def active_param_count(self) -> int:
        """Parameters active per token (MoE: only routed top-k experts)."""
        if not self.moe.enabled:
            return self.param_count()
        m = self.moe
        mult = 3 if self.ffn_act == "swiglu" else 2
        per_expert = mult * self.d_model * m.d_ff_expert
        n_moe = sum(
            1
            for i in range(self.n_layers)
            if i >= m.first_dense and i % m.moe_every == m.moe_offset
        )
        inactive = n_moe * (m.n_experts - m.top_k) * per_expert
        return self.param_count() - inactive


# --------------------------------------------------------------------------- #
# Input shapes
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether a given (arch, shape) cell is runnable. Returns (ok, reason)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 524k-token decode is quadratic; skipped per assignment"
    return True, ""


# --------------------------------------------------------------------------- #
# Reduced (smoke-test) configs
# --------------------------------------------------------------------------- #


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Shrink a full config to something a CPU can forward in <1s.

    Keeps the *family structure* (MoE/MLA/SSM/hybrid wiring) but with tiny dims.
    """
    kw: dict = dict(
        n_layers=max(2, cfg.attn_period or 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_ff=128,
        vocab=256,
        head_dim=16,
        name=cfg.name + "-smoke",
    )
    if cfg.moe.enabled:
        kw["moe"] = replace(
            cfg.moe,
            n_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=32,
            first_dense=min(cfg.moe.first_dense, 1),
            # drop-free so decode == full-forward equivalence tests hold
            # (capacity drops are data-dependent and differ between a 1-token
            # decode batch and the full prefill batch)
            capacity_factor=8.0,
        )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(
            q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16,
        )
    if cfg.ssm is not None:
        kw["ssm"] = replace(cfg.ssm, d_state=16, head_dim=16, chunk=32)
    if cfg.is_encdec:
        kw["n_enc_layers"] = 2
        kw["enc_frames"] = 16
    if cfg.attn_period:
        kw["n_layers"] = cfg.attn_period  # one full period
    return replace(cfg, **kw)


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # populate registry lazily
    from repro_torch import configs as _c  # noqa: F401  (registers them)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from repro_torch import configs as _c  # noqa: F401

    return sorted(_REGISTRY)
