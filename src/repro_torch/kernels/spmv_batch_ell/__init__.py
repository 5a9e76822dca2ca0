"""The spmv_batch_ell kernel family: wrapper, plain version, registry binding."""
