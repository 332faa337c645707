"""pixtral-12b [vlm]: pixtral-ViT frontend STUBBED + mistral-nemo backbone.

[hf:mistralai/Pixtral-12B-2409; unverified]  40L d_model=5120 32H (kv=8)
d_ff=14336 vocab=131072.  input_specs supplies 256 precomputed patch
embeddings (B, 256, 5120) prepended to the token sequence.
Value for value the reference's ``repro.configs.pixtral_12b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral_12b", family="vlm", num_layers=40, d_model=5120,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=131072,
    head_dim=128, num_patches=256, mlp_act="swiglu",
    train_microbatches=4,
    param_dtype="bfloat16", compute_dtype="bfloat16")

SMOKE_CONFIG = CONFIG.replace(
    name="pixtral_smoke", num_layers=2, d_model=128, num_heads=8,
    num_kv_heads=2, d_ff=384, vocab_size=512, head_dim=16, num_patches=8,
    param_dtype="float32", compute_dtype="float32")
