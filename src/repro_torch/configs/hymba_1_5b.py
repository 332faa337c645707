"""hymba-1.5b [hybrid]: parallel attention + Mamba heads per layer.

[arXiv:2411.13676; hf]  32L d_model=1600 25H (kv=5) d_ff=5504 vocab=32001,
ssm_state=16.  25 heads not divisible by 16 -> attn params FSDP-only.
Sub-quadratic long context: sliding-window attention (4096) + SSM state,
so long_500k decode runs.
Value for value the reference's ``repro.configs.hymba_1_5b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba_1_5b", family="hybrid", num_layers=32, d_model=1600,
    num_heads=25, num_kv_heads=5, d_ff=5504, vocab_size=32001,
    ssm_state=16, sliding_window=4096, subquadratic=True, attn_tp=False,
    train_microbatches=4, serve_param_fsdp=False,
    mlp_act="swiglu", param_dtype="bfloat16", compute_dtype="bfloat16")

SMOKE_CONFIG = CONFIG.replace(
    name="hymba_smoke", num_layers=2, d_model=160, num_heads=5,
    num_kv_heads=1, d_ff=384, vocab_size=512, ssm_state=8,
    sliding_window=64, param_dtype="float32", compute_dtype="float32")
