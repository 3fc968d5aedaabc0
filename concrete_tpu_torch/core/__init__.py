"""Core TFHE layers of the port: LWE, GLWE, GGSW, bootstrapping."""
