"""The plain reference the program is held to. It imports neither the
program (``repro_torch``) nor the JAX package (``guard.check_reference``)."""
