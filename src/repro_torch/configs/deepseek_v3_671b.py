"""DeepSeek-V3 671B — MoE, MLA, 1 shared + 256 routed top-8, MTP. [arXiv:2412.19437]"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,          # MLA: all heads read the shared latent KV
    head_dim=128,
    d_ff=18432,              # dense FFN on the first_k_dense layers [arXiv:2412.19437 tab.1]
    vocab_size=129280,
    attention="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_routed_experts=256, n_shared_experts=1, top_k=8,
                  d_ff_expert=2048, first_k_dense=3),
    mtp_depth=1,             # multi-token prediction, depth 1
    rope="rope",
    citation="arXiv:2412.19437",
)
