"""Analytic forward FLOPs of the model families (port of
``sonar_tpu.models.flops``; pure arithmetic, the port keeps its own copy).

Counts matmul and convolution multiply-accumulates only (2 FLOPs per MAC).
Norms, activations, softmax and embeddings are under 1 % at these sizes and
are left out, so the count is a slight under-estimate and the MFU derived
from it a slight under-claim. Each counter walks the structure its module's
forward runs (``models/unet.py`` :class:`UNet`, ``models/dit.py``
:class:`DiT`, ``models/flux.py`` :class:`Flux`); ``tests/test_torch_flops.py``
holds the first two equal to the JAX package's counts and against
``torch.utils.flop_counter.FlopCounterMode`` on the port's modules. FLUX has
no JAX counterpart: ``tests/test_torch_flux.py`` holds its count against
``FlopCounterMode`` alone.

MFU convention, as in the JAX package: float32 programs are reported against
the card's dense bf16 peak, the fraction of the card one could be using.
"""

from __future__ import annotations

# NVIDIA's published dense BF16 Tensor Core peak of the H100 SXM5 (989.4
# TFLOP/s without sparsity; H100 datasheet and Hopper architecture whitepaper).
# "NVIDIA H100 80GB HBM3" is the SXM5 part.
H100_PEAK_FLOPS = 989.4e12


def _conv_flops(hw: int, kh: int, kw: int, cin: int, cout: int) -> float:
    return 2.0 * hw * kh * kw * cin * cout


def _resblock_flops(hw: int, cin: int, cout: int, cemb: int) -> float:
    f = _conv_flops(hw, 3, 3, cin, cout)        # conv1
    f += 2.0 * cemb * cout                      # emb projection (per item)
    f += _conv_flops(hw, 3, 3, cout, cout)      # conv2
    if cin != cout:
        f += _conv_flops(hw, 1, 1, cin, cout)   # 1x1 skip
    return f


def _attention_flops(n: int, c: int) -> float:
    f = 2.0 * n * c * 3 * c                     # qkv projection
    f += 2.0 * n * n * c                        # q @ k^T
    f += 2.0 * n * n * c                        # attn @ v
    f += 2.0 * n * c * c                        # out projection
    return f


def unet_forward_flops(cfg, shape) -> float:
    """FLOPs of ONE UNet forward on a (B, C, H, W) input.

    Level i runs at (H/2^i, W/2^i); downsample convs produce the halved
    grid; upsample convs run at the doubled grid."""
    b, _, h, w = shape
    ch, cemb = cfg.model_channels, cfg.emb_channels
    nlev = len(cfg.channel_mult)

    total = 2.0 * (ch * cemb + cemb * cemb)           # time MLP (per item)
    total += _conv_flops(h * w, 3, 3, cfg.in_channels, ch)

    skip_chs = [ch]
    cur = ch
    hh, ww = h, w
    for level in range(nlev):
        cout = cfg.level_channels(level)
        for _ in range(cfg.num_res_blocks):
            total += _resblock_flops(hh * ww, cur, cout, cemb)
            if level in cfg.attention_levels:
                total += _attention_flops(hh * ww, cout)
            cur = cout
            skip_chs.append(cur)
        if level != nlev - 1:
            hh, ww = hh // 2, ww // 2
            total += _conv_flops(hh * ww, 3, 3, cur, cur)  # strided conv
            skip_chs.append(cur)

    total += _resblock_flops(hh * ww, cur, cur, cemb)      # mid res1
    total += _attention_flops(hh * ww, cur)
    total += _resblock_flops(hh * ww, cur, cur, cemb)      # mid res2

    for level in reversed(range(nlev)):
        cout = cfg.level_channels(level)
        for _ in range(cfg.num_res_blocks + 1):
            cskip = skip_chs.pop()
            total += _resblock_flops(hh * ww, cur + cskip, cout, cemb)
            if level in cfg.attention_levels:
                total += _attention_flops(hh * ww, cout)
            cur = cout
        if level != 0:
            hh, ww = hh * 2, ww * 2
            total += _conv_flops(hh * ww, 3, 3, cur, cur)  # post-resize conv

    total += _conv_flops(h * w, 3, 3, cur, cfg.out_channels)
    return total * b


def dit_forward_flops(cfg, shape) -> float:
    """FLOPs of ONE DiT forward on a (B, C, H, W) input (dense MLP; top-1
    MoE routes the same token count through expert MLPs of the same width,
    so it adds only the router and the dispatch/combine products, counted
    when num_experts > 0)."""
    b, _, h, w = shape
    d = cfg.hidden
    n = (h // cfg.patch_size) * (w // cfg.patch_size)
    pd = cfg.patch_dim

    total = 2.0 * n * pd * d                          # patch embed
    total += 2.0 * (d * d + d * d)                    # sigma MLP (per item)

    per_block = 2.0 * d * 6 * d                       # adaLN modulation
    per_block += _attention_flops(n, d)
    per_block += 2.0 * 2 * n * d * (cfg.mlp_ratio * d)  # MLP in+out
    if cfg.num_experts:
        e = cfg.num_experts
        c = cfg.expert_capacity(n)
        per_block += 2.0 * n * d * e                  # router
        per_block += 2.0 * 2 * n * e * c * d          # dispatch + combine
    total += cfg.depth * per_block

    total += 2.0 * d * 2 * d                          # final adaLN
    total += 2.0 * n * d * pd                         # output head
    return total * b


def flux_forward_flops(cfg, shape, context_tokens: int) -> float:
    """FLOPs of ONE FLUX forward (:class:`~sonar_tpu_torch.models.flux.Flux`)
    on a (B, C, H, W) latent with ``context_tokens`` text tokens: 2×2
    patches, every double and single block's attention over the joint
    sequence of text and image tokens."""
    b, _, h, w = shape
    d, f = cfg.hidden_size, cfg.mlp_hidden
    ni, nt = (h // 2) * (w // 2), context_tokens
    n = ni + nt

    total = 2.0 * ni * cfg.in_channels * d                  # img_in
    total += 2.0 * nt * cfg.context_in_dim * d              # txt_in
    total += 2.0 * (256 * d + d * d) * 2                    # time_in, guidance_in (per item)
    total += 2.0 * (cfg.vec_in_dim * d + d * d)             # vector_in (per item)

    core = 2.0 * 2 * n * n * d                              # q @ k^T, attn @ v
    double = 2 * 2.0 * d * 6 * d                            # two modulations (per item)
    double += 2.0 * n * d * (3 * d + d + 2 * f)             # qkv, proj, MLP of both streams
    total += cfg.depth * (double + core)

    single = 2.0 * d * 3 * d                                # modulation (per item)
    single += 2.0 * n * d * (3 * d + f)                     # linear1
    single += 2.0 * n * (d + f) * d                         # linear2
    total += cfg.depth_single_blocks * (single + core)

    total += 2.0 * d * 2 * d                                # final adaLN
    total += 2.0 * ni * d * cfg.out_channels                # output head
    return total * b


def mfu_pct(flops_per_call: float, per_call_ms: float | None,
            peak: float = H100_PEAK_FLOPS) -> float | None:
    """Model FLOPs utilization (%) from a per-call wall time."""
    if per_call_ms is None or per_call_ms <= 0:
        return None
    return flops_per_call / (per_call_ms / 1e3) / peak * 100.0
