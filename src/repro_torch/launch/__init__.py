"""Entry points of the port: the cohort server and the training launcher."""
