"""chameleon-34b (twin of ``repro/configs/chameleon_34b.py``) — early-fusion
VLM. [arXiv:2405.09818; unverified]

Early fusion = VQ image tokens share the text token stream; the VQ tokenizer
frontend is a STUB (tokens arrive pre-quantized inside the 65536 vocab), so the
backbone is a dense decoder-only transformer.
"""

from repro_torch.configs.base import ModelConfig, register

CHAMELEON_34B = register(
    ModelConfig(
        name="chameleon-34b",
        family="vlm",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab=65536,
        head_dim=128,
        ffn_act="swiglu",
        source="arXiv:2405.09818; unverified",
    )
)
