"""Applications of the port (``repro.apps``): the §6.4 fractional-diffusion
solve (``fractional``)."""
