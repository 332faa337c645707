"""starcoder2-7b [dense]: GQA 36q/4kv, RoPE, GeLU.

[arXiv:2402.19173; hf]  32L d_model=4608 36H (kv=4) d_ff=18432 vocab=49152.
Value for value the reference's ``repro.configs.starcoder2_7b`` (its
``attn_tp=False``, 36 heads over a 16-way model axis, is a sharding
choice that one card does not read).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2_7b", family="dense", num_layers=32, d_model=4608,
    num_heads=36, num_kv_heads=4, d_ff=18432, vocab_size=49152,
    mlp_act="gelu", norm="layernorm", attn_tp=False,
    train_microbatches=4,
    param_dtype="bfloat16", compute_dtype="bfloat16")

SMOKE_CONFIG = CONFIG.replace(
    name="starcoder2_smoke", num_layers=2, d_model=144, num_heads=9,
    num_kv_heads=3, d_ff=576, vocab_size=512,
    param_dtype="float32", compute_dtype="float32")
