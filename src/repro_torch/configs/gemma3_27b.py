"""gemma3-27b [dense] — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt (family card)]

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144, d_head=128.
Layer pattern: groups of 5 sliding-window (1024) + 1 global layer, x10,
plus a 2-local tail (62 = 10*6 + 2).  The sliding-window locals bound KV
memory for 52/62 layers => long_500k runs for this dense arch.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=21504,
    vocab_size=262144,
    group=("swa", "swa", "swa", "swa", "swa", "attn"),
    tail_blocks=("swa", "swa"),
    sliding_window=1024,
    rope_theta=1e6,
    tie_embeddings=True,
    max_seq_len=524288,
)

SMOKE = ModelConfig(
    arch_id="gemma3-27b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_head=32,
    d_ff=256,
    vocab_size=512,
    group=("swa", "attn"),
    sliding_window=16,
    tie_embeddings=True,
    dtype="float32",
    max_seq_len=128,
)
