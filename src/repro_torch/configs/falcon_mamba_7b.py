"""falcon-mamba-7b [ssm] — pure Mamba1, attention-free. [arXiv:2410.05355]

64L d_model=4096 d_ff=0 vocab=65024, ssm_state=16, expand=2 (d_inner 8192).
No attention anywhere; DOMINO applies unchanged (it constrains logits) but
speculative verification snapshots the recurrent state for rollback
(DESIGN.md §Arch-applicability).  O(1) state => long_500k runs.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,            # unused (attention-free)
    n_kv_heads=1,
    d_head=64,
    d_ff=0,
    vocab_size=65024,
    group=("mamba1",),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, version=1),
    max_seq_len=524288,
)

SMOKE = ModelConfig(
    arch_id="falcon-mamba-7b-smoke",
    family="ssm",
    n_layers=2,
    d_model=128,
    n_heads=1,
    n_kv_heads=1,
    d_head=64,
    d_ff=0,
    vocab_size=512,
    group=("mamba1",),
    ssm=SSMConfig(d_state=8, d_conv=4, expand=2, version=1),
    dtype="float32",
    max_seq_len=128,
)
