"""Model configuration (twin of ``repro/configs/base.py``) for the families
the port runs: dense (the serving engine's decode model, minitron-4b) and
ssm (mamba2-2.7b).  Pure data, plus the reduced smoke configs and the
name registry."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


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
    family: str                  # dense | ssm (the families ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    ffn_act: str = "swiglu"      # swiglu (llama-family)
    ssm: Optional[SSMConfig] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    source: str = ""             # citation tag

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 (the reference's padding,
        kept so logits and weights line up with it)."""
        return -(-self.vocab // 256) * 256

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """The reference's reduced config of ``cfg`` (same family wiring, tiny
    dims), for the ported families."""
    kw: dict = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_ff=128,
        vocab=256,
        head_dim=16,
        name=cfg.name + "-smoke",
    )
    if cfg.ssm is not None:
        kw["ssm"] = replace(cfg.ssm, d_state=16, head_dim=16, chunk=32)
    return replace(cfg, **kw)


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from repro_torch import configs as _c  # noqa: F401  (registers them)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
