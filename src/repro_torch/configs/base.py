"""Model configuration (twin of ``repro/configs/base.py``), for the dense
family the serving engine decodes.  Pure data."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense (the only family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    ffn_act: str = "swiglu"      # swiglu (llama-family)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    source: str = ""             # citation tag

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 (the reference's padding,
        kept so logits and weights line up with it)."""
        return -(-self.vocab // 256) * 256

