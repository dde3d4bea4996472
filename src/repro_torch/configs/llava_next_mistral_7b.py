"""llava-next-mistral-7b [vlm] — LLaVA-NeXT with Mistral-7B language backbone.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000 — anyres tiling.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]

Per the assignment carve-out, the SigLIP/CLIP vision tower + projector are a
STUB: input_specs() provides pre-projected patch embeddings (anyres tiling
of up to 4 tiles + base image ~ 2880 tokens of d_model).  The language
backbone is a Mistral-style GQA transformer with 4096-token sliding-window
attention (making long_500k decodable with bounded KV).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    group=("swa",),
    sliding_window=4096,
    rope_theta=1e6,
    n_prefix_tokens=2880,     # anyres: base 576 + 4 tiles x 576
    max_seq_len=524288,
)

SMOKE = ModelConfig(
    arch_id="llava-next-mistral-7b-smoke",
    family="vlm",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    group=("swa",),
    sliding_window=16,
    n_prefix_tokens=8,
    dtype="float32",
    max_seq_len=128,
)
