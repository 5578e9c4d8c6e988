"""The least time of each of the port's own kernels, one file each:
``NAMES`` (substrings of the kernel's name as ``csrc/`` gives it) and
``least_seconds(traffic, itemsize)``, the least time of one of its launches
at the shapes the traffic launches it with, worked out by the file from the
traffic's own keys (its latent ``shape``, its noise and their parameters)."""
