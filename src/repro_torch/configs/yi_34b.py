"""yi-34b [dense] — llama-architecture GQA dense model. [arXiv:2403.04652]

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
Full attention only => long_500k is skipped (DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    group=("attn",),
    rope_theta=5e6,
    max_seq_len=32768,
)

SMOKE = ModelConfig(
    arch_id="yi-34b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    group=("attn",),
    dtype="float32",
    max_seq_len=128,
)
