"""How the program under test is built for each model family, one file
each: ``build(cfg, params, traffic, device)``, the port's module on the
benchmark's weights wrapped as the sampler's denoisers;
``forward_flops(cfg, shape)``, the port's own count of a forward, which the
tests hold the frozen count (``flops/<family>.py``) to; and
``attention_axis()``, the patches of the port's module that plant that
fault (``faults.py``)."""
