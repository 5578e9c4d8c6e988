"""Plain float32 PyTorch references, one file per model family, and the
sampler, guidance and noise stream above them. Nothing here imports the
program, JAX or the JAX package."""
