"""The block_jacobi kernel family: wrapper, plain version, registry binding."""
