"""Analytic forward FLOPs of each model family, one file each
(``forward_flops(cfg, shape)``), frozen from the port's
``models/flops.py`` so that a later change to the program cannot move them."""
