"""FLOPs of one forward of the ``dit`` family (dense MLP) on a
(B, C, H, W) input."""

from .common import attention


def forward_flops(cfg, shape) -> float:
    b, _, h, w = shape
    d, p = cfg["hidden"], cfg["patch_size"]
    n = (h // p) * (w // p)
    pd = p * p * cfg["in_channels"]

    total = 2.0 * n * pd * d                          # patch embed
    total += 2.0 * (d * d + d * d)                    # sigma MLP (per item)

    per_block = 2.0 * d * 6 * d                       # adaLN modulation
    per_block += attention(n, d)
    per_block += 2.0 * 2 * n * d * (cfg["mlp_ratio"] * d)  # MLP in+out
    total += cfg["depth"] * per_block

    total += 2.0 * d * 2 * d                          # final adaLN
    total += 2.0 * n * d * pd                         # output head
    return total * b
