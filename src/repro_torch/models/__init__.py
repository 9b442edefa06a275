"""Models of the port: the paper's federated CNN and the LM (attention,
Mamba-2, the decoder-only transformer)."""
