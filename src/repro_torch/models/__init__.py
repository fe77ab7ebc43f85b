"""The model stack on one device: parameters, layers, the RWKV-6 mixer and
the transformer assembly that serving and training run."""
