"""The model stack: parameters, layers, the MoE, the RWKV-6 and Mamba
mixers and the transformer assembly that serving and training run, on one
device and, for prefill and decode, on a mesh."""
