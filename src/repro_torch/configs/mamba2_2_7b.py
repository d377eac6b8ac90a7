"""mamba2-2.7b — attention-free SSD (state-space duality), twin of
``repro/configs/mamba2_2_7b.py``. [arXiv:2405.21060; unverified]

d_inner = 2*2560 = 5120, head_dim=64 -> 80 SSD heads, d_state=128.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig, register

MAMBA2_2_7B = register(
    ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        n_layers=64,
        d_model=2560,
        n_heads=0,               # attention-free
        n_kv_heads=0,
        d_ff=0,                  # no FFN: mamba blocks only
        vocab=50280,
        head_dim=0,
        ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1,
                      conv_width=4),
        source="arXiv:2405.21060; unverified",
    )
)
