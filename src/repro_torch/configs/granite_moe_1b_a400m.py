"""granite-moe-1b-a400m [moe]: 32 experts, top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]  24L d_model=1024 16H (kv=8)
d_ff=512/expert vocab=49155.
Value for value the reference's ``repro.configs.granite_moe_1b_a400m``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite_moe_1b_a400m", family="moe", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=8, d_ff=512, vocab_size=49155,
    num_experts=32, experts_per_token=8, mlp_act="swiglu",
    train_microbatches=4, serve_param_fsdp=False,
    param_dtype="bfloat16", compute_dtype="bfloat16")

SMOKE_CONFIG = CONFIG.replace(
    name="granite_smoke", num_layers=2, d_model=128, num_heads=8,
    num_kv_heads=4, d_ff=128, vocab_size=512, num_experts=8,
    experts_per_token=2, param_dtype="float32", compute_dtype="float32")
