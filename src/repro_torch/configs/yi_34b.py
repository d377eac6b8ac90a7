"""yi-34b (twin of ``repro/configs/yi_34b.py``) — dense llama-arch GQA kv=8.
[arXiv:2403.04652; hf]

Note: 56 heads is not divisible by the 16-way model axis; GSPMD shards unevenly
(pads to 64) — the waste shows up in the §Roofline useful-FLOPs ratio.
"""

from repro_torch.configs.base import ModelConfig, register

YI_34B = register(
    ModelConfig(
        name="yi-34b",
        family="dense",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab=64000,
        head_dim=128,
        ffn_act="swiglu",
        rope_theta=5_000_000.0,
        source="arXiv:2403.04652; hf",
    )
)
