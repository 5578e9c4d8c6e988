"""Counting rules shared by the families: matmul and convolution
multiply-accumulates only, 2 FLOPs a MAC (norms, activations, softmax and
embeddings are under 1 % at these sizes and are left out, so the count is
a slight under-estimate)."""


def conv(hw: int, kh: int, kw: int, cin: int, cout: int) -> float:
    return 2.0 * hw * kh * kw * cin * cout


def attention(n: int, c: int) -> float:
    f = 2.0 * n * c * 3 * c                     # qkv projection
    f += 2.0 * n * n * c                        # q @ k^T
    f += 2.0 * n * n * c                        # attn @ v
    f += 2.0 * n * c * c                        # out projection
    return f
