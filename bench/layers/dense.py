"""A dense decoder layer: GQA attention and a dense MLP.

A copy of the port's per-stage arithmetic for this kind
(``repro_torch.models.flops.stage_flops`` as of the benchmark's first
version): every forward matrix product, and attention's score and value
products counted whole (non-causal: the PaLM convention).  Biases, norms
and activations count 0."""


def forward_flops(conf, B, S):
    d, H, K = conf["d_model"], conf["n_heads"], conf["n_kv_heads"]
    Dh = conf.get("head_dim") or d // H
    proj = 2 * B * S * d * (H * Dh + 2 * K * Dh) + 2 * B * S * H * Dh * d
    attn = 2 * B * S * S * H * Dh * 2
    mult = 3 if conf["mlp_kind"] in ("swiglu", "geglu") else 2
    mlp = 2 * B * S * d * conf["d_ff"] * mult
    return proj + attn + mlp
