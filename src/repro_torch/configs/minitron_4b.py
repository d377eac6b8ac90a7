"""minitron-4b — pruned nemotron, 256k vocab (twin of
``repro/configs/minitron_4b.py``). [arXiv:2407.14679; hf]"""

from repro_torch.configs.base import ModelConfig, register

MINITRON_4B = register(
    ModelConfig(
        name="minitron-4b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=9216,
        vocab=256000,
        head_dim=128,
        ffn_act="swiglu",
        source="arXiv:2407.14679; hf",
    )
)
