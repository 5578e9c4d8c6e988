"""The reference of each sampler name a traffic file gives:
``sample(denoise, x, sigmas, *, noise, **sonar_config)``, ``noise(step,
sigma, sigma_next)`` giving the step's draw."""
