"""granite-20b (twin of ``repro/configs/granite_20b.py``) — dense llama-arch
code model, MQA (GQA kv=1). [arXiv:2405.04324; hf]"""

from repro_torch.configs.base import ModelConfig, register

GRANITE_20B = register(
    ModelConfig(
        name="granite-20b",
        family="dense",
        n_layers=52,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,            # MQA
        d_ff=24576,
        vocab=49152,
        head_dim=128,
        ffn_act="swiglu",
        source="arXiv:2405.04324; hf",
    )
)
