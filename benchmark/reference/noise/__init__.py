"""The reference of each noise name a traffic file gives:
``sampler(seed, shape, device, **noise_params)`` returns ``noise(step,
sigma, sigma_next)``, the normalized draw of a sampler run from ``seed``."""
