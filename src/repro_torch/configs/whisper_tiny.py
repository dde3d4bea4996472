"""whisper-tiny [audio] — encoder-decoder ASR transformer. [arXiv:2212.04356]

4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865.  The mel-spectrogram +
conv1d frontend is a STUB per the carve-out: input_specs() provides 1500
frame embeddings (30 s at 50 Hz after the conv stride-2) of d_model which
feed the bidirectional encoder; the decoder is the constrained-generation
target.  Encoder-decoder with full attention => long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-tiny",
    family="audio",
    n_layers=4,                 # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    group=("xattn",),
    is_encoder_decoder=True,
    n_encoder_layers=4,
    encoder_seq_len=1500,
    max_seq_len=32768,          # assignment decode shape (past 448 ctx of the card)
    tensor_parallel=False,      # 384-wide/6-head model wastes a 16-way axis
)

SMOKE = ModelConfig(
    arch_id="whisper-tiny-smoke",
    family="audio",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    group=("xattn",),
    is_encoder_decoder=True,
    n_encoder_layers=2,
    encoder_seq_len=16,
    dtype="float32",
    max_seq_len=128,
)
