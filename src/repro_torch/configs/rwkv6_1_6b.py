"""rwkv6-1.6b (Finch) [ssm]: attention-free, data-dependent decay.

[arXiv:2404.05892; unverified]  24L d_model=2048 d_ff=7168 vocab=65536.
Heads = d_model/64 = 32 for the WKV state.  O(1)-state decode.
Value for value the reference's ``repro.configs.rwkv6_1_6b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6_1_6b", family="ssm", num_layers=24, d_model=2048,
    num_heads=32, num_kv_heads=32, d_ff=7168, vocab_size=65536,
    use_rope=False, subquadratic=True, attn_tp=False,
    train_microbatches=4, serve_param_fsdp=False,
    param_dtype="bfloat16", compute_dtype="bfloat16")

SMOKE_CONFIG = CONFIG.replace(
    name="rwkv6_smoke", num_layers=2, d_model=128, num_heads=2,
    num_kv_heads=2, d_ff=448, vocab_size=512,
    param_dtype="float32", compute_dtype="float32")
