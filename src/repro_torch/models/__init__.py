"""Models of the port: the paper's federated CNN."""
