"""whisper-medium [audio, enc-dec]: conv frontend STUBBED.

[arXiv:2212.04356; unverified]  24L (dec) d_model=1024 16H (kv=16)
d_ff=4096 vocab=51865.  Encoder depth 24; input_specs supplies precomputed
frame embeddings (B, S, 1024).  MHA (kv=16 == heads), LayerNorm, GeLU,
learned positions in the real model -> we keep RoPE off.
Value for value the reference's ``repro.configs.whisper_medium``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper_medium", family="encdec", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=16, d_ff=4096, vocab_size=51865,
    encoder_layers=24, mlp_act="gelu", norm="layernorm", use_rope=False,
    train_microbatches=4,
    param_dtype="bfloat16", compute_dtype="bfloat16")

SMOKE_CONFIG = CONFIG.replace(
    name="whisper_smoke", num_layers=2, encoder_layers=2, d_model=128,
    num_heads=8, num_kv_heads=8, d_ff=256, vocab_size=512,
    param_dtype="float32", compute_dtype="float32")
