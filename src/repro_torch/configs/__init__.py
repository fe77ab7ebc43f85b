"""Model configurations: the port's copies of the reference's ten architectures."""
