"""The axpy_norm kernel family: wrapper, plain version, registry binding."""
