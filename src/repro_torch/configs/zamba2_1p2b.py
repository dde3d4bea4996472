"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared-weight attention blocks.
[arXiv:2411.15242]

38 Mamba2 layers, d_model=2048 d_ff=8192 vocab=32000, ssm_state=64; a
single SHARED transformer block (32H kv=32) is invoked every 5 Mamba
blocks (7 invocations; weights shared, per-invocation KV cache).
SSM state is O(1) in context => long_500k runs.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    group=("mamba2", "mamba2", "mamba2", "mamba2", "mamba2", "shared_attn"),
    tail_blocks=("mamba2", "mamba2", "mamba2"),
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, version=2, head_dim=64,
                  n_groups=1),
    max_seq_len=524288,
    # 1.2B params replicate comfortably; 16-way tensor parallelism of the
    # shared-B/C mamba2 einsums is collective-bound (EXPERIMENTS §Perf
    # bonus pair: 290 -> 69 ms collective at train_4k)
    tensor_parallel=False,
)

SMOKE = ModelConfig(
    arch_id="zamba2-1.2b-smoke",
    family="hybrid",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    group=("mamba2", "shared_attn"),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, version=2, head_dim=32,
                  n_groups=1),
    dtype="float32",
    max_seq_len=128,
)
