"""Algorithm I (spectral clustering) and Algorithm II (Deep-Q) pieces."""
