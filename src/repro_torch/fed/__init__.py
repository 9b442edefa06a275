"""Federated-learning helpers the serving path needs (the loop itself is
not ported yet)."""
