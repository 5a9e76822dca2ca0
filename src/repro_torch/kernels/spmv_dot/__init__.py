"""The spmv_dot kernel family: wrapper, plain version, registry binding."""
