"""minicpm-2b [dense] — llama-like arch trained with WSD schedule.
[arXiv:2404.06395]

40L d_model=2304 36H (kv=36, i.e. MHA) d_ff=5760 vocab=122753.
The WSD (warmup-stable-decay) schedule is implemented in
repro/training/optimizer.py and exercised by the training example.
Full attention => long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    group=("attn",),
    tie_embeddings=True,
    max_seq_len=32768,
)

SMOKE = ModelConfig(
    arch_id="minicpm-2b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    group=("attn",),
    tie_embeddings=True,
    dtype="float32",
    max_seq_len=128,
)
