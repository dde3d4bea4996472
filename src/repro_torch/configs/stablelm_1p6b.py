"""stablelm-1.6b [dense] — [hf:stabilityai/stablelm-2-1_6b]

24L d_model=2048 32H (kv=32, MHA) d_ff=5632 vocab=100352.
Full attention => long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    group=("attn",),
    max_seq_len=32768,
)

SMOKE = ModelConfig(
    arch_id="stablelm-1.6b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    group=("attn",),
    dtype="float32",
    max_seq_len=128,
)
