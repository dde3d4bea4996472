"""deepseek-v3-671b [moe] — MLA + 1 shared + 256 routed experts top-8 + MTP.
[arXiv:2412.19437]

61L d_model=7168 128H (MLA latent cache; the assignment's kv=128 denotes
head count) expert d_ff=2048 vocab=129280.  All layers are MoE per the
assigned config line (the HF release has 3 leading dense layers — noted
deviation).  MLA dims per the paper: q_lora 1536, kv_lora 512,
nope/rope head dims 128/64, v_head 128.  MTP (multi-token prediction,
depth 1) is available through the training substrate.
Full attention => long_500k skipped.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,
    vocab_size=129280,
    group=("moe",),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1, capacity_factor=1.25),
    max_seq_len=32768,
)

SMOKE = ModelConfig(
    arch_id="deepseek-v3-671b-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    group=("moe",),
    mla=MLAConfig(q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64,
                  n_shared_experts=1, capacity_factor=2.0),
    dtype="float32",
    max_seq_len=128,
)
