"""jamba-v0.1-52b (twin of ``repro/configs/jamba_v0_1_52b.py``) — hybrid
Mamba+attention 1:7 interleave with MoE. [arXiv:2403.19887; hf]

Each 8-layer period has 1 attention mixer (position 4) and 7 mamba mixers;
every second layer's FFN is a 16-expert top-2 MoE.  Jamba's mamba blocks use
d_state=16.  Runs long_500k via SSM state + KV-sequence-sharded attention on
the 4 attention layers.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, register

JAMBA_V0_1_52B = register(
    ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=65536,
        head_dim=128,
        ffn_act="swiglu",
        moe=MoEConfig(
            n_experts=16,
            top_k=2,
            d_ff_expert=14336,
            moe_every=2,
            moe_offset=1,        # odd layers are MoE
        ),
        ssm=SSMConfig(d_state=16, expand=2, head_dim=64, n_groups=1, conv_width=4),
        attn_period=8,
        attn_pos=4,
        source="arXiv:2403.19887; hf",
    )
)
