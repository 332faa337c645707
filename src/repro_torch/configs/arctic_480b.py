"""arctic-480b [moe]: 128 experts top-2 + dense residual FFN branch.

[hf:Snowflake/snowflake-arctic-base; hf]  35L d_model=7168 56H (kv=8)
d_ff=4864/expert vocab=32000.  56 heads not divisible by 16 -> attn params
FSDP-only; experts EP-sharded 8/chip on the 16-way model axis.
Value for value the reference's ``repro.configs.arctic_480b``.  Its ~480 B
weights do not fit one card: the port runs ``arctic_smoke`` and builds the
full config on the ``meta`` device only.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic_480b", family="moe", num_layers=35, d_model=7168,
    num_heads=56, num_kv_heads=8, d_ff=4864, vocab_size=32000,
    num_experts=128, experts_per_token=2, dense_residual=True,
    attn_tp=False, mlp_act="swiglu", train_microbatches=8,
    seq_parallel=True,
    param_dtype="bfloat16", compute_dtype="bfloat16")

SMOKE_CONFIG = CONFIG.replace(
    name="arctic_smoke", num_layers=2, d_model=112, num_heads=7,
    num_kv_heads=1, d_ff=128, vocab_size=512, num_experts=8,
    experts_per_token=2, param_dtype="float32", compute_dtype="float32")
