"""DeepSeek-V2 236B — MoE, MLA kv_lora=512, 2 shared + 160 routed top-6. [arXiv:2405.04434]"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=12288,              # dense FFN on the first layer [arXiv:2405.04434]
    vocab_size=102400,
    attention="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_routed_experts=160, n_shared_experts=2, top_k=6,
                  d_ff_expert=1536, first_k_dense=1),
    rope="rope",
    citation="arXiv:2405.04434",
)
