"""The spmv_ell kernel family: wrapper, plain version, registry binding."""
