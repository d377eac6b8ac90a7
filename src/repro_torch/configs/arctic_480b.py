"""arctic-480b (twin of ``repro/configs/arctic_480b.py``) — 128-expert top-2
MoE with a parallel dense residual MLP. [hf:Snowflake/snowflake-arctic-base;
hf]
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, register

ARCTIC_480B = register(
    ModelConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,
        vocab=32000,
        head_dim=128,
        ffn_act="swiglu",
        moe=MoEConfig(
            n_experts=128,
            top_k=2,
            d_ff_expert=4864,
            moe_every=1,
            dense_residual=True,   # dense MLP in parallel with the MoE output
        ),
        source="hf:Snowflake/snowflake-arctic-base; hf",
    )
)
