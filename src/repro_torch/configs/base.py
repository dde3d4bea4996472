"""Model configuration schema + the assigned input shapes.

Every assigned architecture gets a ``configs/<id>.py`` exporting
``CONFIG`` (the exact full-scale config) and ``SMOKE`` (a reduced variant of
the same family: <=2 layers, d_model<=512, <=4 experts) used by CPU smoke
tests.  The full configs are exercised only through the multi-pod dry-run
(ShapeDtypeStruct lowering, no allocation).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0           # deepseek-style shared expert(s)
    dense_residual_d_ff: int = 0        # arctic: parallel dense FFN
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    version: int = 1                    # 1 = Mamba1 (selective scan), 2 = Mamba2 (SSD)
    head_dim: int = 64                  # Mamba2 only
    n_groups: int = 1                   # Mamba2 only


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                         # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None        # default d_model // n_heads
    # layer program: (group pattern, repetitions, tail pattern). Block kinds:
    #   'attn'    full-attention transformer block
    #   'swa'     sliding-window attention block
    #   'mla'     multi-head latent attention block (deepseek)
    #   'moe'     MoE FFN block (attention per attn_kind)
    #   'mamba1'/'mamba2'  SSM blocks
    #   'shared_attn'      zamba2 shared-weight attention block
    group: Tuple[str, ...] = ("attn",)
    group_reps: int = 0                 # 0 -> n_layers reps of a 1-block group
    head_blocks: Tuple[str, ...] = ()   # unscanned leading blocks
    tail_blocks: Tuple[str, ...] = ()   # unscanned trailing blocks
    sliding_window: Optional[int] = None
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # encoder-decoder (whisper): encoder consumes stub frame embeddings
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq_len: int = 0            # e.g. 1500 frames for whisper
    # modality frontend stub (vlm/audio): prefix embeddings of this many
    # tokens are provided by input_specs() instead of computed from pixels
    n_prefix_tokens: int = 0
    max_seq_len: int = 131072
    dtype: str = "bfloat16"
    # 'native' stores KV in cfg.dtype; 'int8' stores per-(token,head)
    # scaled int8 (halves the memory-bound decode term; §Perf pair 3)
    kv_cache_dtype: str = "native"
    # small models (whisper-tiny) waste the 16-way model axis: heads don't
    # divide it and SPMD falls back to full rematerialization — turn tensor
    # parallelism off and let them ride the data axis only
    tensor_parallel: bool = True
    # route hot-spots through the Pallas kernels (decode attention, mamba
    # scans); interpret=True on CPU, compiled on TPU
    use_pallas_kernels: bool = False

    def __post_init__(self):
        if self.d_head is None:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    # -- derived -----------------------------------------------------------------

    @property
    def layer_program(self) -> Tuple[Tuple[str, ...], int, Tuple[str, ...], Tuple[str, ...]]:
        """(head_blocks, reps, group, tail_blocks) fully resolved."""
        if self.group_reps == 0:
            def real(blocks):  # shared_attn does not count toward n_layers
                return sum(1 for b in blocks if b != "shared_attn")
            remaining = self.n_layers - real(self.head_blocks) \
                - real(self.tail_blocks)
            reps = remaining // max(1, real(self.group))
            return (self.head_blocks, reps, self.group, self.tail_blocks)
        return (self.head_blocks, self.group_reps, self.group, self.tail_blocks)

    def check(self) -> None:
        head, reps, group, tail = self.layer_program
        n = len(head) + reps * len(group) + len(tail)
        # shared_attn blocks do not count toward n_layers (shared weights,
        # they are "extra" invocations in zamba-style hybrids)
        n_shared = (list(head) + list(group) * reps + list(tail)).count("shared_attn")
        assert n - n_shared == self.n_layers, \
            f"{self.arch_id}: layer program gives {n - n_shared} != {self.n_layers}"

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        dh = self.d_head
        nq, nkv = self.n_heads, self.n_kv_heads
        emb = v * d * (1 if self.tie_embeddings else 2)
        head, reps, group, tail = self.layer_program
        blocks = list(head) + list(group) * reps + list(tail)
        seen_shared = False
        total = emb
        for b in blocks:
            if b == "shared_attn":
                if seen_shared:
                    continue
                seen_shared = True
            total += self._block_params(b)
        if self.is_encoder_decoder:
            total += self.n_encoder_layers * self._block_params("attn")
        return total

    def _block_params(self, kind: str) -> int:
        d, f = self.d_model, self.d_ff
        dh, nq, nkv = self.d_head, self.n_heads, self.n_kv_heads
        attn = d * nq * dh + 2 * d * nkv * dh + nq * dh * d
        mlp3 = 3 * d * f
        if kind in ("attn", "swa", "shared_attn"):
            return attn + mlp3 + 2 * d
        if kind == "xattn":
            return 2 * attn + mlp3 + 3 * d
        if kind == "mla":
            m = self.mla
            q = d * m.q_lora_rank + m.q_lora_rank * nq * (
                m.qk_nope_head_dim + m.qk_rope_head_dim)
            kv = d * (m.kv_lora_rank + m.qk_rope_head_dim) + \
                m.kv_lora_rank * nq * (m.qk_nope_head_dim + m.v_head_dim)
            o = nq * m.v_head_dim * d
            return q + kv + o + mlp3 + 2 * d
        if kind == "moe":
            mo = self.moe
            experts = mo.n_experts * 3 * d * mo.d_ff_expert
            shared = mo.n_shared_experts * 3 * d * mo.d_ff_expert
            dense = 3 * d * mo.dense_residual_d_ff
            router = d * mo.n_experts
            base_attn = (self._block_params("mla") - mlp3 - 2 * d
                         if self.mla else attn)
            return base_attn + experts + shared + dense + router + 2 * d
        if kind in ("mamba1", "mamba2"):
            s = self.ssm
            d_in = s.expand * d
            if s.version == 1:
                return (d * 2 * d_in + s.d_conv * d_in
                        + d_in * (s.d_state * 2 + d_in // 16)  # x_proj(B,C,dt_rank)
                        + (d_in // 16) * d_in                  # dt_proj
                        + d_in * s.d_state + d_in              # A, D
                        + d_in * d + d)                        # out_proj, norm
            n_heads_m = d_in // s.head_dim
            conv_dim = d_in + 2 * s.n_groups * s.d_state
            return (d * (2 * d_in + 2 * s.n_groups * s.d_state + n_heads_m)
                    + s.d_conv * conv_dim + n_heads_m * 2
                    + d_in * d + d_in + d)
        raise ValueError(kind)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed-active experts)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        inactive = (mo.n_experts - mo.top_k) * 3 * self.d_model * mo.d_ff_expert
        head, reps, group, tail = self.layer_program
        n_moe = (list(head) + list(group) * reps + list(tail)).count("moe")
        return self.param_count() - n_moe * inactive


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
