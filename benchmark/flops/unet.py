"""FLOPs of one forward of the ``unet`` family on a (B, C, H, W) input.
Level i runs at (H/2^i, W/2^i); downsample convs produce the halved grid;
upsample convs run at the doubled grid."""

from .common import attention, conv


def _resblock(hw: int, cin: int, cout: int, cemb: int) -> float:
    f = conv(hw, 3, 3, cin, cout)               # conv1
    f += 2.0 * cemb * cout                      # emb projection (per item)
    f += conv(hw, 3, 3, cout, cout)             # conv2
    if cin != cout:
        f += conv(hw, 1, 1, cin, cout)          # 1x1 skip
    return f


def forward_flops(cfg, shape) -> float:
    b, _, h, w = shape
    ch = cfg["model_channels"]
    cemb = 4 * ch
    mult = cfg["channel_mult"]
    nlev = len(mult)
    att = set(cfg["attention_levels"])

    total = 2.0 * (ch * cemb + cemb * cemb)           # time MLP (per item)
    total += conv(h * w, 3, 3, cfg["in_channels"], ch)

    skip_chs = [ch]
    cur = ch
    hh, ww = h, w
    for level in range(nlev):
        cout = ch * mult[level]
        for _ in range(cfg["num_res_blocks"]):
            total += _resblock(hh * ww, cur, cout, cemb)
            if level in att:
                total += attention(hh * ww, cout)
            cur = cout
            skip_chs.append(cur)
        if level != nlev - 1:
            hh, ww = hh // 2, ww // 2
            total += conv(hh * ww, 3, 3, cur, cur)  # strided conv
            skip_chs.append(cur)

    total += _resblock(hh * ww, cur, cur, cemb)      # mid res1
    total += attention(hh * ww, cur)
    total += _resblock(hh * ww, cur, cur, cemb)      # mid res2

    for level in reversed(range(nlev)):
        cout = ch * mult[level]
        for _ in range(cfg["num_res_blocks"] + 1):
            cskip = skip_chs.pop()
            total += _resblock(hh * ww, cur + cskip, cout, cemb)
            if level in att:
                total += attention(hh * ww, cout)
            cur = cout
        if level != 0:
            hh, ww = hh * 2, ww * 2
            total += conv(hh * ww, 3, 3, cur, cur)  # post-resize conv

    total += conv(h * w, 3, 3, cur, cfg["out_channels"])
    return total * b
