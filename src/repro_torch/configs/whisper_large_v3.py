"""whisper-large-v3 (twin of ``repro/configs/whisper_large_v3.py``) — enc-dec
audio backbone. [arXiv:2212.04356; unverified]

The conv frontend is a STUB: ``input_specs()`` provides precomputed
(enc_frames, d_model) frame embeddings.  32 encoder + 32 decoder layers,
GELU FFN, full (non-causal) encoder attention, causal decoder self-attention
plus cross-attention to the encoder output.
"""

from repro_torch.configs.base import ModelConfig, register

WHISPER_LARGE_V3 = register(
    ModelConfig(
        name="whisper-large-v3",
        family="audio",
        n_layers=32,              # decoder depth
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab=51866,
        head_dim=64,
        ffn_act="gelu",
        is_encdec=True,
        n_enc_layers=32,
        enc_frames=1500,
        source="arXiv:2212.04356; unverified",
    )
)
