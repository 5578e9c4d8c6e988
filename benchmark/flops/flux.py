"""FLOPs of one forward of the ``flux`` family on a (B, C, H, W) input:
2×2 patches, ``context_tokens`` text tokens, joint attention over both."""


def forward_flops(cfg, shape) -> float:
    b, _, h, w = shape
    d, f = cfg["hidden_size"], cfg["mlp_ratio"] * cfg["hidden_size"]
    ni, nt = (h // 2) * (w // 2), cfg["context_tokens"]
    n = ni + nt

    total = 2.0 * ni * cfg["in_channels"] * d              # img_in
    total += 2.0 * nt * cfg["context_in_dim"] * d           # txt_in
    total += 2.0 * (256 * d + d * d) * 2                    # time_in, guidance_in (per item)
    total += 2.0 * (cfg["vec_in_dim"] * d + d * d)          # vector_in (per item)

    core = 2.0 * 2 * n * n * d                              # q @ k^T, attn @ v
    double = 2 * 2.0 * d * 6 * d                            # two modulations (per item)
    double += 2.0 * n * d * (3 * d + d + 2 * f)             # qkv, proj, MLP of both streams
    total += cfg["depth"] * (double + core)

    single = 2.0 * d * 3 * d                                # modulation (per item)
    single += 2.0 * n * d * (3 * d + f)                     # linear1
    single += 2.0 * n * (d + f) * d                         # linear2
    total += cfg["depth_single_blocks"] * (single + core)

    total += 2.0 * d * 2 * d                                # final adaLN
    total += 2.0 * ni * d * cfg["out_channels"]             # output head
    return total * b
