"""The reference of each ``pipeline`` name: ``denoiser(network, params,
config, traffic, dtype)`` gives the guided denoiser ``denoise(x, sigma)``."""
