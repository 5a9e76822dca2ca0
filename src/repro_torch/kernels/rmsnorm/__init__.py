"""The rmsnorm kernel family: wrapper, plain version, registry binding."""
