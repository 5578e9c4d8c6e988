"""How the program under test is built for each model family: the port's
module on the benchmark's weights, wrapped as the sampler's denoisers."""
