"""The spmv_sellp kernel family: wrapper, plain version, registry binding."""
