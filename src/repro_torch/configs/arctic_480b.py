"""arctic-480b [moe] — dense-MoE hybrid: every layer has a parallel dense
residual FFN + a 128-expert top-2 MoE. [hf:Snowflake/snowflake-arctic-base]

35L d_model=7168 56H (GQA kv=8) expert d_ff=4864 vocab=32000.
Full attention => long_500k skipped.  Experts are sharded over the model
axis (expert parallelism), expert d_ff over the data/fsdp axis.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    group=("moe",),
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                  dense_residual_d_ff=4864, capacity_factor=1.25),
    max_seq_len=32768,
)

SMOKE = ModelConfig(
    arch_id="arctic-480b-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    group=("moe",),
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128,
                  dense_residual_d_ff=128, capacity_factor=2.0),
    dtype="float32",
    max_seq_len=128,
)
