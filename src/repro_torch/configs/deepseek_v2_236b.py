"""deepseek-v2-236b (twin of ``repro/configs/deepseek_v2_236b.py``) — MoE with
MLA. [arXiv:2405.04434; hf]

MLA kv_lora=512 (+64 rope dims cached), 128 heads.  MoE: 2 shared + 160 routed
experts, top-6, expert d_ff=1536; layer 0 keeps a dense FFN (d_ff=12288, per
the released model).  The XLB expert relay (core.relay) is the dispatch path.
"""

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, register

DEEPSEEK_V2_236B = register(
    ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,           # MLA: latent cache, logical kv = n_heads
        d_ff=12288,               # dense FFN used on first_dense layers
        vocab=102400,
        head_dim=128,
        ffn_act="swiglu",
        moe=MoEConfig(
            n_experts=160,
            top_k=6,
            n_shared_experts=2,
            d_ff_expert=1536,
            moe_every=1,
            first_dense=1,
        ),
        mla=MLAConfig(
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        source="arXiv:2405.04434; hf",
    )
)
