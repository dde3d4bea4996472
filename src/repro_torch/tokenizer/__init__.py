from repro_torch.tokenizer.bpe import BPETokenizer, train_bpe

__all__ = ["BPETokenizer", "train_bpe"]
