"""glm4-9b [dense]: GQA 32q/2kv, RoPE, SwiGLU.

[hf:THUDM/glm-4-9b; hf]  40L d_model=4096 32H (kv=2) d_ff=13696
vocab=151552.
Value for value the reference's ``repro.configs.glm4_9b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4_9b", family="dense", num_layers=40, d_model=4096,
    num_heads=32, num_kv_heads=2, d_ff=13696, vocab_size=151552,
    mlp_act="swiglu", train_microbatches=4,
    param_dtype="bfloat16", compute_dtype="bfloat16")

SMOKE_CONFIG = CONFIG.replace(
    name="glm4_smoke", num_layers=2, d_model=128, num_heads=8,
    num_kv_heads=2, d_ff=384, vocab_size=512,
    param_dtype="float32", compute_dtype="float32")
